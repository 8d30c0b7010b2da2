"""The port's CLI vs the JAX package's: the parsers, ``crop`` on an mp4 and
on a reference ``.pkl``, ``eval``, and the GPU-by-default rule.

Both CLIs run with their model builders patched to the narrow models of
``test_torch_ingest_stream.py`` (the same weights; the port on the CPU
through ``--device cpu``).  ``benchmark`` is in
``test_torch_cli_benchmark.py``.
"""

import numpy as np
import pytest
import torch

from test_torch_ingest_stream import (
    CUTS,
    stream_frames,
    stream_models,
    write_clip_pickle,
    write_mp4,
)

torch.set_num_threads(1)


def full_annotation_tree(root, frame_counts, seed=0):
    """annotator_{1..6}/NNN_<ar>.txt for all 200 RetargetVid videos (the
    CLI loads them all): ``frame_counts[v]`` frames for the videos named,
    3 for the rest."""
    from retargetvid_tpu_torch.eval.annotations import (
        ASPECT_RATIOS,
        VID_INDS,
        write_boxes_file,
    )
    rng = np.random.default_rng(seed)
    for k in range(1, 7):
        d = root / f'annotator_{k}'
        d.mkdir(parents=True)
        for v in VID_INDS:
            n = frame_counts.get(v, 3)
            for ar in ASPECT_RATIOS:
                if ar == '1-3':
                    x = rng.integers(-3, 520, n)
                    b = np.stack([x, 0 * x, x + 120, 0 * x + 360], 1)
                else:
                    y = rng.integers(-3, 146, n)
                    b = np.stack([0 * y, y, 0 * y + 640, y + 214], 1)
                write_boxes_file(d / f'{v:03d}_{ar}.txt', b)
    return root


def patch_cli(monkeypatch, fns):
    """Both CLIs' streaming model builders -> the narrow models; the JAX
    CLI's persistent-cache setup -> nothing."""
    import retargetvid_tpu.cli as jcli
    import retargetvid_tpu.utils.cache as jcache
    import retargetvid_tpu_torch.cli as cli

    jtn, jsal, ttn, tsal = fns
    monkeypatch.setattr(jcli, '_build_models', lambda args: (jtn, jsal))
    monkeypatch.setattr(cli, '_build_models', lambda args: (ttn, tsal))
    monkeypatch.setattr(jcache, 'enable_compilation_cache', lambda: None)
    return jcli, cli


@pytest.fixture(scope='module')
def fns():
    return stream_models()


def _parsed(argv):
    """(JAX args, port args) for ``argv``, without running a command."""
    import retargetvid_tpu.cli as jcli
    import retargetvid_tpu.utils.cache as jcache
    from retargetvid_tpu_torch.cli import build_parser

    seen = {}
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jcache, 'enable_compilation_cache', lambda: None)
        for name in ('cmd_crop', 'cmd_benchmark', 'cmd_eval'):
            mp.setattr(jcli, name, lambda args: seen.setdefault('a', args))
        jcli.main(argv)
    finally:
        mp.undo()
    return vars(seen['a']), vars(build_parser().parse_args(argv))


@pytest.mark.parametrize('argv', [
    ['crop', 'v.mp4'], ['benchmark'], ['eval', 'results', '--annotations',
                                       'annots']])
def test_parser_defaults(argv, monkeypatch):
    monkeypatch.delenv('UNISAL_WEIGHTS', raising=False)
    monkeypatch.delenv('TRANSNET_WEIGHTS', raising=False)
    ref, got = _parsed(argv)
    for args in (ref, got):
        args.pop('fn')
    assert ref.pop('mesh', 0) == got.pop('mesh', 0) == 0
    if argv[0] != 'eval':
        assert got.pop('device') == 'cuda'
        # The port's own choice of shot detector; V1 is the JAX CLI's.
        assert got.pop('transnet_arch') == 'v1'
    assert got == ref
    monkeypatch.setenv('UNISAL_WEIGHTS', '/w/u.pth')
    monkeypatch.setenv('TRANSNET_WEIGHTS', '/w/t.pkl')
    if argv[0] != 'eval':
        ref, got = _parsed(argv)
        assert got['unisal_weights'] == ref['unisal_weights'] == '/w/u.pth'
        assert got['transnet_weights'] == ref['transnet_weights'] == \
            '/w/t.pkl'


@pytest.mark.parametrize('kind', ['mp4', 'pkl'])
def test_crop(kind, fns, monkeypatch, tmp_path, capsys):
    """The same boxes file; on a ``.pkl`` with ``--save-vid`` the same
    cropped ``_sc.pkl``."""
    import pickle

    jcli, cli = patch_cli(monkeypatch, fns)
    frames = stream_frames()
    outs = {}
    for side, main, extra in (('jax', jcli.main, []),
                              ('port', cli.main, ['--device', 'cpu'])):
        d = tmp_path / side
        d.mkdir()
        if kind == 'mp4':
            src = write_mp4(d / '001.mp4', frames)
        else:
            src = write_clip_pickle(d / '001.pkl', frames,
                                    trans_inds=[c - 1 for c in CUTS])
        argv = ['crop', str(src), '--ratio', '1:3', '--out', str(d / 'out')]
        if kind == 'pkl':
            argv.append('--save-vid')
        main(argv + extra)
        outs[side] = (d / 'out.txt').read_bytes()
        if kind == 'pkl':
            with open(d / '001_sc.pkl', 'rb') as fp:
                outs[side + '_sc'] = pickle.load(fp)
        printed = capsys.readouterr().out
        assert ' (180x320)->(140x250)->(180x60)->(180x60)' in printed
    assert outs['port'] == outs['jax']
    assert outs['port'].count(b'\n') == len(frames)
    if kind == 'pkl':
        got, ref = outs['port_sc'], outs['jax_sc']
        assert sorted(got) == sorted(ref)
        for k in ref:
            assert np.array_equal(np.asarray(got[k]), np.asarray(ref[k])), k


def test_eval(tmp_path):
    """``eval`` writes the JAX CLI's file, byte for byte."""
    import retargetvid_tpu.cli as jcli
    import retargetvid_tpu.utils.cache as jcache
    from retargetvid_tpu_torch.cli import main
    from retargetvid_tpu_torch.eval.annotations import write_boxes_file

    annots = full_annotation_tree(tmp_path / 'annots', {1: 6, 601: 4})
    rng = np.random.default_rng(5)
    for run in ('run_a', 'run_b'):
        d = tmp_path / 'results' / run
        d.mkdir(parents=True)
        for v, n in ((1, 6), (601, 4)):
            x = rng.integers(0, 500, n)
            write_boxes_file(d / f'{v:03d}_1-3.txt',
                             np.stack([x, 0 * x, x + 120, 0 * x + 360], 1))
    argv = ['eval', str(tmp_path / 'results'), '--annotations', str(annots)]
    main(argv + ['--out', str(tmp_path / 'port.txt')])
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jcache, 'enable_compilation_cache', lambda: None)
        jcli.main(argv + ['--out', str(tmp_path / 'jax.txt')])
    finally:
        mp.undo()
    text = (tmp_path / 'port.txt').read_bytes()
    assert text == (tmp_path / 'jax.txt').read_bytes()
    assert text.count(b'\n') == 3 and b'run_b' in text


def test_needs_a_gpu_unless_asked_for_cpu(tmp_path):
    from retargetvid_tpu_torch.cli import main

    if torch.cuda.is_available():
        pytest.skip('a GPU is present: the no-GPU contract is moot')
    for argv in (['crop', str(tmp_path / 'v.mp4')],
                 ['benchmark', '--videos', str(tmp_path)],
                 ['crop', str(tmp_path / 'v.mp4'), '--device', 'cuda']):
        with pytest.raises(RuntimeError, match='CUDA'):
            main(argv)
