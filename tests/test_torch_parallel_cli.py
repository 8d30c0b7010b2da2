"""``cli benchmark --mesh 2 [--oneshot] --device cpu`` in two processes
against the JAX CLI's single-device runs.

The videos, annotations and narrow float32 models are
``test_torch_cli_benchmark.py``'s (``001.mp4``, ``002.mp4``: 48 frames at
72x128, a hard cut at frame 24).  Each rank is started as a user starts
one (``RTV_NUM_PROCS``/``RTV_PROC_ID``/``RTV_COORD``, the store a
``file://`` URL), patches the port CLI's model loaders to the narrow
models, and calls ``cli.main``, which joins the group itself.  The two
clips share one signature, so they run as one dp-2 group.

- ``--oneshot``: the box files equal JAX's ``cli benchmark --oneshot``
  files (JAX's own bound for its sharded one-shot CLI is 1 px), and the
  inline IoU lines are JAX's;
- sequential reference: the box files are within 1 px of JAX's
  sequential ``cli benchmark`` files on under 5% of the boxes (the bounds of
  ``tests/test_cli_benchmark_sharded.py``);
- the ``_info.txt`` keys and non-timing lines are those JAX's
  ``_oneshot_info``/``_sharded_info`` give for the same clip with ``dp=2``;
- rank 0 alone writes and prints.

The sequential reference runs in ``test_torch_parallel_cli_sharded.py``.
"""

import contextlib
import functools
import io

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_cli import full_annotation_tree, patch_cli
from test_torch_ingest_stream import FPS, Detector, stream_frames, write_mp4
from test_torch_oneshot import models
from test_torch_parallel_mesh import ok_results, run_ranks

torch.set_num_threads(1)

FC, H, W = 48, 72, 128
VIDS = ('001', '002')


def _rank_cli(rank, argv, tn, un, transnet_fn):
    """One rank of ``cli benchmark --mesh``: the port CLI with its model
    loaders patched to the narrow float32 models; returns its stdout."""
    import retargetvid_tpu_torch.cli as cli
    import retargetvid_tpu_torch.parallel.runner as runner

    cli._load_oneshot_models = lambda args: (tn, un)
    cli._sharded_models = lambda args: (transnet_fn, un)
    runner.ShardedOneShot = functools.partial(runner.ShardedOneShot,
                                              dtype=torch.float32)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(argv)
    return out.getvalue().splitlines()


@pytest.fixture(scope='module')
def setup(tmp_path_factory):
    from retargetvid_tpu.models.transnet import TransNetPredictor as JPred
    from retargetvid_tpu.pipeline.saliency import SaliencyPredictor as JSal
    from retargetvid_tpu_torch.models.transnet import TransNetPredictor

    root = tmp_path_factory.mktemp('mesh_cli')
    (root / 'videos').mkdir()
    for i, name in enumerate(VIDS):
        write_mp4(root / 'videos' / f'{name}.mp4',
                  stream_frames(FC, H, W, cuts=(24,), seed=i))
    annots = full_annotation_tree(root / 'annots', {1: FC, 2: FC})
    jt, tn_params, ju, un_vars, tn, un = models(f=2, d=16)
    return dict(root=root, annots=annots,
                jax=(jt, tn_params, ju, un_vars,
                     Detector(JPred(jt, tn_params)),
                     JSal(variables=un_vars, model=ju, chunk=8).predict),
                port=(tn, un, Detector(TransNetPredictor(tn, device='cpu'))))


def _argv(setup, side, extra):
    return ['benchmark', '--videos', str(setup['root'] / 'videos'), '--out',
            str(setup['root'] / side), '--test-name', 'run',
            '--annotations', str(setup['annots'])] + extra


def _iou_lines(lines):
    return [ln for ln in lines if ln.startswith(('   user #', '   mean'))]


def _info(path):
    """(keys in order, non-timing key -> value) of an ``_info.txt`` file or
    of an info dict."""
    if isinstance(path, dict):
        text = ''.join(f'{k}:{v}\n' for k, v in path.items())
    else:
        text = path.read_text()
    pairs = [ln.split(':', 1) for ln in text.splitlines() if ':' in ln]
    return [k for k, _ in pairs], {k: v for k, v in pairs
                                   if not k.startswith('t_')}


def test_benchmark_mesh_oneshot(setup, monkeypatch, capsys, tmp_path):
    check_benchmark_mesh(setup, monkeypatch, capsys, tmp_path, oneshot=True)


def check_benchmark_mesh(setup, monkeypatch, capsys, tmp_path, oneshot):
    """The JAX CLI's run, then the port's two ranks, then the files (the
    sequential reference is ``test_torch_parallel_cli_sharded.py``'s)."""
    import retargetvid_tpu.cli as jcli_mod
    import retargetvid_tpu.pipeline.oneshot as joneshot
    from retargetvid_tpu.config import sc_init_crop_params
    from retargetvid_tpu.eval.annotations import read_boxes_file
    from retargetvid_tpu.ops.boxes import calc_dest_size
    from retargetvid_tpu.pipeline.ingest import sal_dims

    jt, tn_params, ju, un_vars, jtn_fn, jsal_fn = setup['jax']
    jcli, _ = patch_cli(monkeypatch, (jtn_fn, jsal_fn, None, None))
    monkeypatch.setattr(jcli, '_load_oneshot_models',
                        lambda args: (jt, tn_params, un_vars))
    monkeypatch.setattr(joneshot, 'OneShotClipProgram', functools.partial(
        joneshot.OneShotClipProgram, model=ju, dtype=jnp.float32))
    mode = ['--oneshot'] if oneshot else []
    side = 'oneshot' if oneshot else 'sharded'
    capsys.readouterr()
    jcli.main(_argv(setup, f'jax_{side}', mode))
    jious = _iou_lines(capsys.readouterr().out.splitlines())

    lines = ok_results(run_ranks(
        _rank_cli, 2, tmp_path, _argv(setup, f'port_{side}', mode + [
            '--mesh', '2', '--device', 'cpu']), *setup['port'],
        join='fn'))
    jdir = setup['root'] / f'jax_{side}' / 'run'
    pdir = setup['root'] / f'port_{side}' / 'run'
    names = sorted(p.name for p in pdir.iterdir())
    assert names == sorted(p.name for p in jdir.iterdir())
    assert names == sorted(f'{v}_{ar}{s}' for v in VIDS
                           for ar in ('1-3', '3-1')
                           for s in ('.txt', '_info.txt'))
    # Rank 0 alone writes and prints.
    assert any('sharded' in ln for ln in lines[0])
    assert not [ln for ln in lines[1] if 'boxes' in ln or 'user #' in ln]
    pious = _iou_lines(lines[0])
    assert len(pious) == len(jious) == 4 * 7

    cp = sc_init_crop_params()
    sal_hw = sal_dims(W, H, cp['max_input_d'])
    clip = {'sal_frames': np.zeros((FC,) + sal_hw + (3,), np.uint8),
            'fc': FC, 'fps': FPS, 'h_orig': H, 'w_orig': W}
    for v in VIDS:
        for ar in ('1:3', '3:1'):
            suffix = f"{v}_{ar.replace(':', '-')}"
            got = read_boxes_file(pdir / f'{suffix}.txt')
            ref = read_boxes_file(jdir / f'{suffix}.txt')
            assert got.shape == ref.shape == (FC, 4)
            diff = np.abs(got - ref)
            assert diff.max() <= 1, suffix
            if oneshot:
                assert (diff == 0).all(), suffix
            else:
                assert (diff > 0).mean() < 0.05, suffix
            rcp = dict(cp, out_ratio=ar, tpu_transnet_fullseq=True)
            dest = calc_dest_size(W, H, ar)
            if oneshot:
                want = jcli_mod._oneshot_info(
                    rcp, result='smart cropped (oneshot dp=2)', h=H, w=W,
                    sal_hw=sal_hw, dest=dest, boxes=got, fc=FC, fps=FPS,
                    t_read=0.0, t_dev=0.0)
            else:
                want = jcli_mod._sharded_info(rcp, clip, dest, got, 0.0, 2)
            assert _info(pdir / f'{suffix}_info.txt') == _info(want), suffix
    if oneshot:
        # The same IoU blocks (6 annotators and the mean per clip and
        # ratio); the sharded run serves a group ratio by ratio.
        def blocks(ious):
            return sorted(tuple(ious[i:i + 7]) for i in range(0, len(ious), 7))
        assert blocks(pious) == blocks(jious)
