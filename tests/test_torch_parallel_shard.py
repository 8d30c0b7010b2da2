"""The port's row-sharded layers (``parallel/shard.py:ModelShard``) op by
op against their single-device versions, on levels that leave sp ranks
without rows.

On a (1,4,1) mesh of CPU gloo ranks, for every level of H=64 (2 rows at
1/32: shards of 1, 0, 1, 0 rows) and H=96 (3 rows at 1/32: 1, 1, 1, 0),
as ``UNISAL``'s backbone descends them: ``halo``, ``conv`` (3x3 at
stride 1 and 2, depthwise 3x3, 1x1), ``resize`` (linear to twice the
level and to the level below, which may leave ranks no output rows,
nearest to the input height), ``replicate_pad`` and
``log_softmax``.  Each rank's output is held to its window of the
single-device op's output (rows outside the frame zero for the halo,
edge rows for the padding), and each rank's input gradient under a seeded
upstream gradient to the single-device gradient of the same windowed sum,
within 1e-5 absolute + 1e-5 relative.  A rank without rows gets an output
of zero rows and still runs every exchange forward and backward: a rank
that skipped one would leave the others waiting until the ranks' timeout.
The (1,2,2) case adds tp: at H=32 the 1-row level leaves the second sp
rank empty on both tp ranks, with each conv's weight split over tp.

This module imports neither JAX nor the JAX package, so its rank function
runs in spawned ranks free of them (``test_torch_parallel_mesh.run_ranks``).
"""

import numpy as np
import pytest
import torch
from torch import nn
from torch.nn import functional as F

from test_torch_parallel_mesh import ok_results, run_ranks

torch.set_num_threads(1)

N, C, W = 2, 4, 6
ATOL = RTOL = 1e-5
HALO, PAD = 1, 5
#: (name, conv arguments) of the convs checked, ``in_channels`` C.
CONVS = [('conv3x3', dict(out_channels=6, kernel_size=3, padding=1)),
         ('conv3x3_s2', dict(out_channels=6, kernel_size=3, padding=1,
                             stride=2)),
         ('depthwise', dict(out_channels=C, kernel_size=3, padding=1,
                            groups=C, bias=False)),
         ('conv1x1', dict(out_channels=6, kernel_size=1))]
OPS = ['halo', *(name for name, _ in CONVS), 'resize_linear',
       'resize_down', 'resize_nearest', 'replicate_pad', 'log_softmax']


def make_conv(name):
    """The conv ``name`` of :data:`CONVS`, its weights from a seed."""
    i, kw = next((i, kw) for i, (n, kw) in enumerate(CONVS) if n == name)
    conv = nn.Conv2d(C, **kw)
    rng = np.random.default_rng(i)
    with torch.no_grad():
        for p in conv.parameters():
            p.copy_(torch.from_numpy(
                rng.standard_normal(tuple(p.shape)).astype(np.float32)))
    return conv


def levels(h):
    """The levels of the backbone below height ``h`` (five halvings)."""
    out = [h]
    for _ in range(5):
        out.append((out[-1] + 1) // 2)
    return out


def frames(h, level):
    return torch.from_numpy(np.random.default_rng([h, level]).standard_normal(
        (N, C, level, W)).astype(np.float32))


def upstream(h, level, op, i, shape):
    return torch.from_numpy(np.random.default_rng(
        [h, level, OPS.index(op), i]).standard_normal(shape).astype(
            np.float32))


def run_op(op, x, h, level, sharded=None, tp=(0, 1)):
    """``op`` on ``x`` at ``level``: the single-device version, or the
    sharded one on ``sharded`` (``tp``: ``(index, size)`` of this rank's
    tp group, whose split weights it holds)."""
    if op == 'halo':
        return F.pad(x, (0, 0, HALO, HALO)) if sharded is None \
            else sharded.halo(x, HALO)
    if op.startswith('conv') or op == 'depthwise':
        conv = make_conv(op)
        if sharded is None:
            return conv(x)
        if tp[1] > 1:
            n = conv.out_channels // tp[1]
            conv.weight = nn.Parameter(conv.weight.detach()[
                tp[0] * n:(tp[0] + 1) * n].clone())
        return sharded.conv(conv, x)
    if op.startswith('resize'):
        from retargetvid_tpu_torch.ops.resize import resize
        out_hw = {'resize_linear': (2 * level, 2 * W),
                  'resize_down': ((level + 1) // 2, W)}.get(op, (h, W))
        method = 'nearest' if op == 'resize_nearest' else 'linear'
        if sharded is None:
            return resize(x, out_hw, method, channels_last=False)
        return sharded.resize(x, out_hw, method)
    if op == 'replicate_pad':
        return F.pad(x, (PAD,) * 4, mode='replicate') if sharded is None \
            else sharded.replicate_pad(x, PAD)
    from retargetvid_tpu_torch.models.unisal import spatial_log_softmax
    return spatial_log_softmax(x) if sharded is None \
        else sharded.log_softmax(x)


def shard_rank(rank, sizes, heights):
    """One rank: for each height, level and op, this rank's output and
    its input's gradient under :func:`upstream`'s gradient."""
    from retargetvid_tpu_torch.parallel.mesh import make_mesh
    from retargetvid_tpu_torch.parallel.shard import ModelShard

    mesh = make_mesh(axis_sizes=sizes, device='cpu')
    i = mesh.coords['sp']
    tp = (mesh.coords['tp'], sizes[2])
    out = {}
    for h in heights:
        sharded = ModelShard(mesh, h, True)
        for _ in range(5):              # register the backbone's levels
            sharded.descend()
        for level in levels(h):
            s, e = sharded.at(level).rows()
            x = frames(h, level)[..., s:e, :].clone().requires_grad_()
            for op in OPS:
                y = run_op(op, x, h, level, sharded.at(level), tp)
                g = upstream(h, level, op, i, tuple(y.shape))
                gx, = torch.autograd.grad(y, x, g)
                out[h, level, op] = y.detach().numpy(), gx.numpy()
    return out


def level_parts(h, sp):
    """Each level's row shards, from the input's even split down."""
    from retargetvid_tpu_torch.parallel.shard import split_rows
    parts = {h: split_rows(h, sp)}
    for a, b in zip(levels(h), levels(h)[1:]):
        parts[b] = tuple(((s + 1) // 2, (e + 1) // 2) for s, e in parts[a])
    return lambda level: parts.get(level) or split_rows(level, sp)


def window(op, h, level, parts, i):
    """Rank ``i``'s rows of the single-device output of ``op``."""
    s, e = parts(level)[i]
    if op == 'halo':
        return s, e + 2 * HALO
    if op == 'replicate_pad':
        return s, e + 2 * PAD
    if op == 'conv3x3_s2':
        return (s + 1) // 2, (e + 1) // 2
    if op == 'resize_linear':
        return parts(2 * level)[i]
    if op == 'resize_down':
        return parts((level + 1) // 2)[i]
    if op == 'resize_nearest':
        return parts(h)[i]
    return s, e


CASES = [((1, 4, 1), (64, 96)), ((1, 2, 2), (32,))]


@pytest.mark.parametrize('sizes, heights', CASES,
                         ids=['x'.join(map(str, s)) for s, _ in CASES])
def test_row_ops_match_single_device(sizes, heights, tmp_path):
    from retargetvid_tpu_torch.parallel.mesh import Mesh

    world = int(np.prod(sizes))
    res = ok_results(run_ranks(shard_rank, world, tmp_path, sizes, heights))
    sp_of = [Mesh(sizes, rank=r, device='cpu').coords['sp']
             for r in range(world)]
    empty = 0
    for h in heights:
        parts = level_parts(h, sizes[1])
        for level in levels(h):
            empty += sum(e == s for s, e in parts(level))
            for op in OPS:
                x = frames(h, level).requires_grad_()
                y = run_op(op, x, h, level)
                loss = 0.0
                for r, out in enumerate(res):
                    got = out[h, level, op][0]
                    s, e = window(op, h, level, parts, sp_of[r])
                    label = f'{op} h={h} level {level} rank {r}'
                    np.testing.assert_allclose(
                        got, y.detach()[..., s:e, :].numpy(), rtol=RTOL,
                        atol=ATOL, err_msg=label)
                    if r == sp_of.index(sp_of[r]):
                        g = upstream(h, level, op, sp_of[r], got.shape)
                        loss = loss + (y[..., s:e, :] * g).sum()
                ref, = torch.autograd.grad(loss, x)
                for r, out in enumerate(res):
                    s, e = parts(level)[sp_of[r]]
                    np.testing.assert_allclose(
                        out[h, level, op][1], ref[..., s:e, :].numpy(),
                        rtol=RTOL, atol=ATOL,
                        err_msg=f'{op} h={h} level {level} rank {r} grad')
    assert empty, 'no level left a rank without rows'
