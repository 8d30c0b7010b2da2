"""The port's mesh, sharding rules and process-group runtime
(``retargetvid_tpu_torch/parallel/mesh.py``, ``distributed.py``) against the
JAX package's, plus :func:`run_ranks`, which the other
``test_torch_parallel_*`` files use to run gloo ranks.

Ranks are spawned CPU processes (``spawn``, never ``fork``) joined by gloo
over a ``file://`` store in the test's ``tmp_path`` (no TCP port, so xdist
workers never collide); each rank has a join timeout and the group a
collective timeout, so a rank that dies fails the test instead of hanging
it.  This module imports neither JAX nor the JAX package at its top, so
ranks that import it stay free of them.
"""

import multiprocessing
import os
import pickle
import time
import traceback

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

#: Seconds a rank's collectives wait for the others.
RANK_TIMEOUT_S = 60.0


def _rank_main(fn, rank, world, init_method, out_path, args, join):
    """One spawned rank: join the group, run ``fn(rank, *args)``, pickle
    ``('ok', result)`` or ``('error', traceback)`` to ``out_path``, leave
    the group on every path.  ``join``: ``'init'`` (``initialize`` over
    gloo), ``'env'`` (``initialize_from_env`` on the CPU) or ``'fn'`` (only
    the ``RTV_*`` variables are set; ``fn`` joins)."""
    torch.set_num_threads(1)
    from retargetvid_tpu_torch.parallel import distributed
    status = 0
    os.environ['RTV_DIST_TIMEOUT'] = str(RANK_TIMEOUT_S)
    try:
        if join == 'init':
            distributed.initialize(rank, world, init_method, 'gloo',
                                   timeout_s=RANK_TIMEOUT_S)
        else:
            os.environ.update(RTV_NUM_PROCS=str(world),
                              RTV_PROC_ID=str(rank), RTV_COORD=init_method)
        if join == 'env':
            assert distributed.initialize_from_env('cpu')
        result = ('ok', fn(rank, *args))
    except Exception:                               # noqa: BLE001
        result = ('error', traceback.format_exc())
        status = 1
    finally:
        distributed.shutdown()
    with open(out_path, 'wb') as fp:
        pickle.dump(result, fp)
    os._exit(status)


def run_ranks(fn, world, tmp_path, *args, timeout=240.0, join='init',
              name='ranks'):
    """``fn(rank, *args)`` on ``world`` spawned gloo ranks; returns each
    rank's ``(status, result)`` and exit code.  Ranks still alive after
    ``timeout`` seconds are killed and the test fails."""
    ctx = multiprocessing.get_context('spawn')
    store = tmp_path / f'{name}.store'
    outs = [tmp_path / f'{name}.rank{r}.pkl' for r in range(world)]
    procs = [ctx.Process(target=_rank_main, args=(
        fn, r, world, f'file://{store}', str(outs[r]), args, join))
        for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert not hung, f'ranks {hung} still running after {timeout} s'
    results = []
    for out, p in zip(outs, procs):
        res = None
        if out.exists():
            with open(out, 'rb') as fp:
                res = pickle.load(fp)
        results.append((res, p.exitcode))
    return results


def ok_results(results):
    """The ranks' results, failing on any rank that raised."""
    for r, (res, code) in enumerate(results):
        assert res is not None and res[0] == 'ok' and code == 0, \
            f'rank {r} (exit {code}):\n{res[1] if res else "no result"}'
    return [res[1] for res, _ in results]


MESH_CASES = [(8, None), (1, None), (8, (2, 2, 2)), (8, (1, 1, 8)),
              (4, (2, 1, 2))]


@pytest.mark.parametrize('n, sizes', MESH_CASES,
                         ids=[f'{n}-{s}' for n, s in MESH_CASES])
def test_mesh_layout_matches_jax(n, sizes):
    """The mesh's shape and each rank's coordinates are JAX's
    ``make_mesh(n, axis_sizes)``: its shape, and the position of device r
    in its device array."""
    import jax

    from retargetvid_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from retargetvid_tpu_torch.parallel.mesh import Mesh, mesh_shape

    ref = jax_make_mesh(n, axis_sizes=sizes)
    shape = mesh_shape(n, sizes)
    assert shape == dict(ref.shape)
    ids = np.vectorize(lambda d: d.id)(ref.devices)
    for r, dev in enumerate(jax.devices()[:n]):
        mesh = Mesh(shape.values(), rank=r, device='cpu')
        pos = tuple(int(i) for i in np.argwhere(ids == dev.id)[0])
        assert tuple(mesh.coords[a] for a in ('dp', 'sp', 'tp')) == pos
        assert mesh.ranks_on(**mesh.coords) == [r]


@pytest.mark.parametrize('tp, threshold', [(2, 256), (2, 16), (8, 16)])
def test_param_shardings_match_jax(tp, threshold):
    """Leaf for leaf over full-width UNISAL: the port splits the dimension
    that holds the JAX leaf's split axis, exactly where JAX splits."""
    import jax
    import jax.numpy as jnp

    from retargetvid_tpu.models.unisal import UNISAL as JUNISAL
    from retargetvid_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from retargetvid_tpu.parallel.mesh import param_shardings as jax_rule
    from retargetvid_tpu_torch.convert import flax_name
    from retargetvid_tpu_torch.models.unisal import UNISAL
    from retargetvid_tpu_torch.parallel.mesh import Mesh, param_shardings

    ju = JUNISAL()
    shapes = jax.eval_shape(lambda: ju.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 1, 64, 64, 3)), static=True))
    jmesh = jax_make_mesh(8, axis_sizes=(8 // tp, 1, tp))
    ref = jax_rule(jmesh, shapes, tp_threshold=threshold)
    port = UNISAL()
    got = param_shardings(Mesh((8 // tp, 1, tp), device='cpu'), port,
                          tp_threshold=threshold)
    state = port.state_dict()
    stat = {'mean': 'running_mean', 'var': 'running_var'}
    n_split = 0
    for path, sh in jax.tree_util.tree_flatten_with_path(ref)[0]:
        keys = [k.key for k in path]
        if keys[0] == 'params':
            name = flax_name(keys[1:])
        else:
            name = '.'.join(keys[1:-1] + [stat[keys[-1]]])
        leaf = shapes
        for k in keys:
            leaf = leaf[k]
        assert name in got, name
        split = 'tp' in tuple(sh.spec)
        assert (got[name] is not None) == split, name
        if split:
            n_split += 1
            assert state[name].shape[got[name]] == leaf.shape[-1], name
    assert n_split > 0
    assert all(got[k] is None for k in got if k.endswith('tracked'))


def _collectives(rank):
    """A (2, 1, 2) mesh of 4 ranks: layout, ``global_put`` blocks and
    ``global_fetch`` in dp order (one shard per dp index), and unequal
    shapes refused on every rank."""
    from retargetvid_tpu_torch.parallel.distributed import (
        global_fetch,
        global_put,
        is_multiprocess,
    )
    from retargetvid_tpu_torch.parallel.mesh import (
        Sharding,
        batch_sharding,
        make_mesh,
    )

    mesh = make_mesh(4, axis_sizes=(2, 1, 2), device='cpu')
    full = np.arange(4 * 6 * 2).reshape(4, 6, 2)
    put = global_put({'x': full, 'nested': [full[0]]},
                     batch_sharding(mesh, 3, spatial_axis=1))
    rep = global_put(full, Sharding(mesh))
    # Ranks of one dp index hold the same shard; the tp coordinate is
    # folded in so a wrong pick shows.
    fetched = global_fetch(torch.tensor([mesh.dp_index, mesh.coords['tp'],
                                         rank]), mesh)
    try:
        global_fetch(torch.zeros(rank + 1), mesh)
    except ValueError as exc:
        refused = str(exc)
    else:
        refused = None
    return {'multi': is_multiprocess(), 'shape': mesh.shape,
            'coords': mesh.coords, 'x': put['x'].numpy(),
            'nested': put['nested'][0].numpy(), 'full': rep.numpy(),
            'fetched': fetched, 'refused': refused}


def test_collectives_on_four_ranks(tmp_path):
    res = ok_results(run_ranks(_collectives, 4, tmp_path))
    full = np.arange(4 * 6 * 2).reshape(4, 6, 2)
    for rank, r in enumerate(res):
        assert r['multi'] and r['shape'] == {'dp': 2, 'sp': 1, 'tp': 2}
        assert r['coords'] == {'dp': rank // 2, 'sp': 0, 'tp': rank % 2}
        # B over dp, H over sp (sp is 1: whole rows).
        np.testing.assert_array_equal(r['x'], full[2 * (rank // 2):][:2])
        np.testing.assert_array_equal(r['nested'],
                                      full[0][3 * (rank // 2):][:3])
        np.testing.assert_array_equal(r['full'], full)
        np.testing.assert_array_equal(r['fetched'], [[0, 0, 0], [1, 0, 2]])
        assert r['refused'] and 'different shapes' in r['refused']


def _env_mesh(rank):
    from retargetvid_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(device='cpu')
    with pytest.raises(ValueError, match='one process per device'):
        make_mesh(1, device='cpu')
    return mesh.shape, mesh.rank, str(mesh.device)


def test_initialize_from_env_two_ranks(tmp_path):
    """``RTV_NUM_PROCS``/``RTV_PROC_ID``/``RTV_COORD`` join a gloo group on
    the CPU; the default mesh spans the world, a smaller one is refused."""
    res = ok_results(run_ranks(_env_mesh, 2, tmp_path, join='env'))
    assert res == [({'dp': 2, 'sp': 1, 'tp': 1}, r, 'cpu') for r in (0, 1)]


def _dies(rank):
    from retargetvid_tpu_torch.parallel.distributed import global_fetch
    from retargetvid_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(device='cpu')
    global_fetch(torch.zeros(2), mesh)
    if rank == 1:
        os._exit(3)
    t0 = time.monotonic()
    try:
        global_fetch(torch.zeros(2), mesh)
    except Exception as exc:                            # noqa: BLE001
        return ('raised', type(exc).__name__, time.monotonic() - t0)
    return ('returned', None, time.monotonic() - t0)


def test_dead_rank_fails_the_collective(tmp_path):
    """A rank that dies between collectives makes the other's next gather
    raise within the group's timeout; nothing hangs."""
    t0 = time.monotonic()
    (res0, code0), (res1, code1) = run_ranks(_dies, 2, tmp_path)
    assert code1 == 3 and res1 is None
    assert res0[0] == 'ok' and res0[1][0] == 'raised', res0
    assert res0[1][2] < RANK_TIMEOUT_S + 10
    assert time.monotonic() - t0 < 2 * RANK_TIMEOUT_S + 60


def test_no_device_or_backend_fallback(tmp_path, monkeypatch):
    """Without a GPU the default device raises, and an NCCL group on a
    build without NCCL raises; neither falls back to gloo or the CPU."""
    import torch.distributed as dist

    from retargetvid_tpu_torch.parallel import distributed
    from retargetvid_tpu_torch.parallel.mesh import make_mesh

    if torch.cuda.is_available():
        pytest.skip('a GPU is present: the no-GPU contract is moot')
    with pytest.raises(RuntimeError, match='CUDA'):
        make_mesh()
    monkeypatch.setenv('RTV_NUM_PROCS', '2')
    monkeypatch.setenv('RTV_PROC_ID', '0')
    monkeypatch.setenv('RTV_COORD', f'file://{tmp_path / "store"}')
    with pytest.raises(RuntimeError, match='CUDA'):
        distributed.initialize_from_env()
    assert not dist.is_initialized()
    if not dist.is_nccl_available():
        with pytest.raises(RuntimeError):
            distributed.initialize(0, 1, f'file://{tmp_path / "s2"}',
                                   'nccl', timeout_s=5)
    assert not dist.is_initialized()
    monkeypatch.setenv('RTV_NUM_PROCS', '1')
    assert distributed.initialize_from_env('cpu') is False
    assert not distributed.is_multiprocess()


def _sig_clip(t_all, n_sel, fc, n_seg=1):
    """``tests/test_cli_benchmark_sharded.py``'s clip stub."""
    return {'sal_frames': np.zeros((t_all, 16, 16, 3), np.uint8),
            'selected': list(range(n_sel)),
            'segmentation': [[0, fc - 1]] * n_seg, 'fc': fc}


@pytest.mark.parametrize('dp', [1, 2, 3])
def test_grouping_matches_jax(dp):
    """``group_clips``/``group_raw_clips`` and both signatures give JAX's
    batches (the same items, in the same order, the same real counts) on
    the cases of ``tests/test_cli_benchmark_sharded.py`` and
    ``tests/test_sharded_oneshot.py``, plus a second segment bucket."""
    from retargetvid_tpu.parallel import runner as jrunner
    from retargetvid_tpu_torch.parallel import runner

    clips = [_sig_clip(30, 6, 30), _sig_clip(31, 6, 31),
             _sig_clip(200, 40, 200), _sig_clip(29, 5, 29),
             _sig_clip(30, 6, 30, n_seg=6)]
    raws = [{'raw': np.zeros((fc, 90, 160, 3), np.uint8), 'fps': fps}
            for fc, fps in ((52, 30.0), (60, 30.0), (40, 30.0),
                            (70, 30.0), (52, 25.0))]
    for got_fn, ref_fn, items, sig, jsig in (
            (runner.group_clips, jrunner.group_clips, clips,
             runner.clip_signature, jrunner.clip_signature),
            (runner.group_raw_clips, jrunner.group_raw_clips, raws,
             lambda it: runner.raw_clip_signature(it['raw'], it['fps']),
             lambda it: jrunner.raw_clip_signature(it['raw'], it['fps']))):
        assert [sig(it) for it in items] == [jsig(it) for it in items]
        got, ref = got_fn(items, dp), ref_fn(items, dp)
        assert [([id(x) for x in b], n) for b, n in got] == \
            [([id(x) for x in b], n) for b, n in ref]
    if dp == 2:
        # The JAX tests' own expectations.
        sizes = sorted((len(b), n) for b, n in runner.group_clips(clips[:4],
                                                                   2))
        assert sizes == [(2, 1), (2, 1), (2, 2)]
        assert [(len(b), n) for b, n in runner.group_raw_clips(raws[:3], 2)
                ] == [(2, 2), (2, 1)]
