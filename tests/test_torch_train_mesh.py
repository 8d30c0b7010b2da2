"""Mesh training of the port (``Trainer`` on a (dp, sp, tp) mesh of CPU
gloo ranks) against its single-device ``Trainer``.

At ``TINY_UNISAL_CFG`` on the JAX mesh test's batch (4, 2, 64, 64) and at
H=96 over sp=2 (the 1/32 level's 3 rows split 2 + 1), from seeded weights
with statistics drawn from a seed: one DHF1K train step with the backbone
trained and dropout live (the trainer's generator, seeded alike on every
rank) on the meshes (2,1,1), (1,2,1), (1,1,2), (2,2,1) at
``tp_threshold=16``: the loss and each summand within 1e-5 relative (1e-5
absolute), every parameter and BatchNorm statistic of the gathered full
tree within 1e-5 absolute + 1e-4 relative, on every rank; under tp=2 a
rank holds half of each split weight's output channels, and of its trace;
the same step without the gradient clip (a clipped step cannot see a
gradient scaled as a whole, so this is where each leaf's gradient shows),
two ``fit_epoch`` steps within 1e-2 (JAX's trajectory bound); a batch
that dp does not divide raises.  The (1,4,1) mesh at H=64 and H=96 leaves
sp ranks without rows at 1/32 (1, 0, 1, 0 and 1, 1, 1, 0 rows).  The
8-rank (2,2,2) case, JAX's own mesh, and (1,8,1) at DHF1K's training
height 224 (1/32: seven rows over eight ranks) are in the ``mesh`` tier.

This module imports neither JAX nor the JAX package, so its rank functions
run in spawned ranks free of them (``test_torch_parallel_mesh.run_ranks``).
"""

import numpy as np
import pytest
import torch

from test_torch_parallel_mesh import ok_results, run_ranks

torch.set_num_threads(1)

#: ``tests/conftest.py:TINY_UNISAL_CFG`` (conftest imports JAX).
TINY = dict(cnn_widen_factor=0.25, cnn_last_channel=None,
            rnn_input_channels=32, rnn_hidden_channels=32,
            smoothing_ksize=11, smoothing_rank=4)
ATOL, RTOL = 1e-5, 1e-4
TP_THRESHOLD = 16
#: A clip the step's gradient norm never reaches.
UNCLIPPED = 1e30
MESHES = [(2, 1, 1), (1, 2, 1), (1, 1, 2), (2, 2, 1)]


def make_tree(seed=3):
    """The port's seeded tiny UNISAL as JAX trees, its statistics drawn
    from ``seed`` (variances in [0.5, 1.5])."""
    from retargetvid_tpu_torch.convert import state_dict_to_flax
    from retargetvid_tpu_torch.models.init import seeded_init_
    from retargetvid_tpu_torch.models.unisal import UNISAL

    tree = state_dict_to_flax(seeded_init_(UNISAL(**TINY), seed))
    rng = np.random.default_rng(seed)

    def draw(node):
        return {k: draw(v) if isinstance(v, dict) else (
            rng.uniform(0.5, 1.5, v.shape) if k == 'var'
            else 0.2 * rng.standard_normal(v.shape)).astype(np.float32)
            for k, v in node.items()}

    tree['batch_stats'] = draw(tree['batch_stats'])
    return tree


def make_batch(h=64, seed=3):
    """``tests/test_train_parallel.py``'s mesh batch at height ``h``."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (4, 2, h, 64, 3)).astype(np.float32)
    sal = np.zeros((4, 2, h, 64, 1), np.float32)
    sal[:, :, 20:30, 20:30, 0] = 1.0
    sal /= sal.sum(axis=(2, 3, 4), keepdims=True)
    fix = (rng.random((4, 2, h, 64, 1)) > 0.99).astype(np.float32)
    return x, sal, fix


def fixed_mask(shape, keep):
    """``tests/test_torch_unisal_train.py:fixed_mask`` (one mask per shape,
    singleton axes dropped), here free of JAX for the ranks."""
    key = tuple(int(s) for s in shape if s != 1)
    seed = sum((i + 3) * s for i, s in enumerate(key)) + int(keep * 1000)
    rng = np.random.default_rng(seed)
    return (rng.random(key) < keep).reshape(tuple(int(s) for s in shape))


def new_trainer(tree, mesh=None, seed=5, grad_clip=2.0):
    from retargetvid_tpu_torch.train.trainer import Trainer

    tr = Trainer(model_cfg=TINY, device='cpu', steps_per_epoch=10,
                 grad_clip=grad_clip)
    tr.init_state(variables=tree, mesh=mesh, tp_threshold=TP_THRESHOLD)
    tr.generator.manual_seed(seed)
    return tr


def one_step(tree, arrays, mesh=None, grad_clip=2.0, train_cnn=True):
    """One DHF1K step (backbone trained unless ``train_cnn`` is False)
    from ``tree``: the trainer and its metrics."""
    tr = new_trainer(tree, mesh, grad_clip=grad_clip)
    x, sal, fix, layout = tr._shard_arrays(*arrays)
    tr.state, m = tr.step_fn('DHF1K', False, train_cnn)(tr.state, x, sal,
                                                        fix, layout)
    return tr, {k: float(v) for k, v in m.items()}


def two_epochs(tree, arrays, mesh=None):
    tr = new_trainer(tree, mesh)
    return [tr.fit_epoch([('DHF1K', *arrays)], epoch=e)['loss']
            for e in range(2)]


def train_rank(rank, sizes, tree, arrays, masks='live', trajectory=False,
               unclipped=True, chkpnt_dir=None, train_cnn=True):
    """One rank of a mesh of ``sizes``: one step (``masks``: ``live`` from
    the generator, ``fixed`` from :func:`fixed_mask`), the gathered full
    tree, the local shapes of the split weights and traces; optionally
    the step without the clip, :func:`two_epochs`, and the step's
    checkpoint written to ``chkpnt_dir`` and read back on the mesh;
    ``train_cnn`` as :func:`one_step`'s."""
    from retargetvid_tpu_torch.models import dropout
    from retargetvid_tpu_torch.parallel.mesh import make_mesh

    if masks == 'fixed':
        dropout.keep_mask = lambda shape, keep, gen: torch.from_numpy(
            fixed_mask(shape, keep))
    mesh = make_mesh(axis_sizes=sizes, device='cpu')
    tr, metrics = one_step(tree, arrays, mesh, train_cnn=train_cnn)
    params = tr._params()
    out = {'coords': mesh.coords, 'metrics': metrics,
           'tree': tr._flax_tree(),
           'split': {n: (tuple(params[n].shape),
                         tuple(tr.state.opt_state['trace'][n].shape), d)
                     for n, d in tr._tp_dims.items()}}
    # Without the clip (the step's gradient norm exceeds it, and a clipped
    # step is blind to a gradient scaled as a whole): the step then
    # carries every leaf's gradient as it is.
    if unclipped:
        out['tree_unclipped'] = one_step(
            tree, arrays, mesh, grad_clip=UNCLIPPED)[0]._flax_tree()
    if chkpnt_dir is not None:
        path = tr.save_chkpnt(chkpnt_dir, 0)
        back = new_trainer(tree, mesh)
        back.load_chkpnt(path)
        out['reloaded'] = back._flax_tree()
        out['reloaded_trace'] = flax_trace(back)
        out['trace'] = flax_trace(tr)
    if trajectory:
        out['losses'] = two_epochs(tree, arrays, mesh)
    return out


def flax_trace(tr):
    """The trainer's full momentum trace as a JAX ``params`` tree."""
    from retargetvid_tpu_torch.convert import flax_param_tree
    return flax_param_tree(tr.model, tr._full(tr.state.opt_state['trace']))


def flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def assert_trees_close(got, ref, label):
    got, ref = dict(flat(got)), dict(flat(ref))
    assert set(got) == set(ref), label
    for path in ref:
        np.testing.assert_allclose(got[path], ref[path], rtol=RTOL,
                                   atol=ATOL, err_msg=f'{label} {path}')


def assert_metrics_close(got, ref, label):
    assert set(got) == set(ref), label
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=1e-5,
                                   err_msg=f'{label} {k}')


@pytest.fixture(scope='module')
def tree():
    return make_tree()


@pytest.fixture(scope='module')
def single(tree):
    """The single-device step per height: (metrics, full tree)."""
    cache = {}

    def get(h):
        if h not in cache:
            tr, m = one_step(tree, make_batch(h))
            cache[h] = m, tr._flax_tree(), one_step(
                tree, make_batch(h), grad_clip=UNCLIPPED)[0]._flax_tree()
        return cache[h]

    return get


CASES = [(s, 64) for s in MESHES] + [((1, 2, 1), 96)]
#: Meshes whose 1/32 level leaves sp ranks without rows: 2 rows over 4
#: ranks at H=64 (1, 0, 1, 0), 3 at H=96 (1, 1, 1, 0).
ROW_CASES = [((1, 4, 1), 64), ((1, 4, 1), 96)]


def case_ids(cases):
    return [f'{"x".join(map(str, s))}-h{h}' for s, h in cases]


@pytest.mark.parametrize('sizes, h', CASES + ROW_CASES,
                         ids=case_ids(CASES + ROW_CASES))
def test_mesh_step_matches_single_device(sizes, h, tree, single, tmp_path):
    world = int(np.prod(sizes))
    res = ok_results(run_ranks(train_rank, world, tmp_path, sizes, tree,
                               make_batch(h), 'live', sizes == (2, 2, 1)))
    ref_m, ref_tree, ref_unclipped = single(h)
    for r, out in enumerate(res):
        label = f'mesh {sizes} h={h} rank {r}'
        assert_metrics_close(out['metrics'], ref_m, label)
        assert_trees_close(out['tree'], ref_tree, label)
        assert_trees_close(out['tree_unclipped'], ref_unclipped,
                           f'{label} unclipped')
        if sizes[2] > 1:
            # tp=2: half of each split weight's output channels, and of
            # its trace; the gathered tree above is the full one.
            assert out['split'], label
            full = dict(new_trainer(tree).model.named_parameters())
            for name, (shape, trace, dim) in out['split'].items():
                want = list(full[name].shape)
                want[dim] //= 2
                assert shape == trace == tuple(want), (label, name)
        else:
            assert not out['split'], label
    if sizes == (2, 2, 1):
        ref = two_epochs(tree, make_batch(h))
        for out in res:
            np.testing.assert_allclose(out['losses'], ref, rtol=1e-2,
                                       atol=1e-2)
            assert out['losses'][1] < out['losses'][0]


def test_indivisible_batch_raises():
    """JAX's error: B=3 over dp=8."""
    from retargetvid_tpu_torch.parallel.mesh import Mesh
    from retargetvid_tpu_torch.train.trainer import Trainer

    tr = Trainer(model_cfg=TINY, device='cpu', steps_per_epoch=10)
    tr.mesh = Mesh((8, 1, 1), device='cpu')
    with pytest.raises(ValueError, match='not divisible'):
        tr._shard_batch(np.zeros((3, 2, 64, 64, 3), np.float32))


def assert_eight_ranks_match(sizes, h, tree, single, tmp_path):
    res = ok_results(run_ranks(train_rank, 8, tmp_path, sizes, tree,
                               make_batch(h), timeout=600.0))
    ref_m, ref_tree, ref_unclipped = single(h)
    for r, out in enumerate(res):
        assert_metrics_close(out['metrics'], ref_m, f'rank {r}')
        assert_trees_close(out['tree'], ref_tree, f'rank {r}')
        assert_trees_close(out['tree_unclipped'], ref_unclipped,
                           f'rank {r} unclipped')


@pytest.mark.mesh
def test_mesh_222_matches_single_device(tree, single, tmp_path):
    """JAX's own mesh, (2, 2, 2) on 8 ranks."""
    assert_eight_ranks_match((2, 2, 2), 64, tree, single, tmp_path)


@pytest.mark.mesh
def test_mesh_181_at_dhf1k_height_matches_single_device(tree, single,
                                                        tmp_path):
    """(1, 8, 1) at DHF1K's training height, 224 (64 columns): its 7
    rows at 1/32 leave the last of the 8 sp ranks without rows."""
    assert_eight_ranks_match((1, 8, 1), 224, tree, single, tmp_path)
