"""The PyTorch port imports neither JAX nor the JAX package, and its entry
points never fall back to the CPU or to the plain kernel versions.

The ``cuda`` case runs on the card without JAX: ``python -m pytest
tests/test_torch_import.py -m cuda --noconftest``.
"""

import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def _port_modules():
    import retargetvid_tpu_torch
    names = ['retargetvid_tpu_torch']
    for info in pkgutil.walk_packages(retargetvid_tpu_torch.__path__,
                                      'retargetvid_tpu_torch.'):
        names.append(info.name)
    return names


def test_port_imports_no_jax(tmp_path):
    mods = _port_modules()
    assert len(mods) >= 20, mods
    for name in ('cli', 'pipeline.crop', 'pipeline.render', 'io.video',
                 'eval.harness', 'models.torch_import', 'utils.timing',
                 'models.convgru', 'utils.sequence', 'train.data',
                 'io.native_reader', 'models.shot_scoring',
                 'models.transnet_post', 'models.dropout', 'train.losses',
                 'train.trainer', 'train.measure', 'eval.saliency_metrics',
                 'parallel', 'parallel.mesh', 'parallel.distributed',
                 'parallel.runner', 'parallel.collectives',
                 'parallel.shard', 'dryrun', 'bench', 'mfu'):
        assert f'retargetvid_tpu_torch.{name}' in mods, name
    code = ('import importlib, sys\n'
            f'for m in {mods!r}: importlib.import_module(m)\n'
            'import chip_smoke\n'
            # ``cli predict`` on a missing file runs until the reader finds
            # no frames, so it has imported all it uses.
            'from retargetvid_tpu_torch.cli import main\n'
            'try:\n'
            "    main(['predict', 'missing.mp4', '--device', 'cpu'])\n"
            'except FileNotFoundError:\n'
            '    pass\n'
            'else:\n'
            "    sys.exit('cli predict read frames from a missing file')\n"
            # ``cli train`` builds the trainer, then finds no dataset;
            # ``cli score`` builds it, then finds no weights.
            "for argv in (['train', '--sources', 'DHF1K'],\n"
            "             ['score', '--train-dir', 'missing_run']):\n"
            '    try:\n'
            "        main(argv + ['--device', 'cpu'])\n"
            '    except FileNotFoundError:\n'
            '        pass\n'
            '    else:\n'
            "        sys.exit(f'cli {argv[0]} ran without data')\n"
            # ``cli benchmark --mesh 1 [--oneshot]`` on an empty folder
            # builds the mesh, the models and the runner.
            # The bench clip's model FLOPs, counted on the meta device.
            'from retargetvid_tpu_torch import mfu\n'
            'from retargetvid_tpu_torch.dryrun import TINY_UNISAL\n'
            'from retargetvid_tpu_torch.models.transnet import TransNetV1\n'
            'from retargetvid_tpu_torch.models.unisal import UNISAL\n'
            'mfu.clip_flops(UNISAL(**TINY_UNISAL), TransNetV1(f=2, d=16))\n'
            "for extra in ([], ['--oneshot']):\n"
            "    main(['benchmark', '--videos', 'missing_dir', '--out',\n"
            f"          {str(tmp_path)!r}, '--mesh', '1', '--device',\n"
            "          'cpu'] + extra)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'flax' or m.startswith('flax.') "
            "or m == 'retargetvid_tpu' or m.startswith('retargetvid_tpu.'))\n"
            'print(bad)\n'
            'sys.exit(1 if bad else 0)\n')
    env = {k: v for k, v in os.environ.items() if k != 'DHF1K_DATA_DIR'}
    res = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_entry_points_need_a_gpu_unless_asked_for_cpu(tmp_path):
    from retargetvid_tpu_torch.device import resolve_device
    from retargetvid_tpu_torch.models.transnet import (
        IngestShotProgram,
        TransNetPredictor,
        TransNetV1,
    )
    from retargetvid_tpu_torch.models.unisal import UNISAL
    from retargetvid_tpu_torch.parallel.mesh import make_mesh
    from retargetvid_tpu_torch.parallel.runner import (
        ShardedClipRunner,
        ShardedOneShot,
        ShardedSaliency,
    )
    from retargetvid_tpu_torch.pipeline.fused import FusedClipProgram
    from retargetvid_tpu_torch.pipeline.oneshot import OneShotClipProgram
    from retargetvid_tpu_torch.pipeline.saliency import SaliencyPredictor
    from retargetvid_tpu_torch.train.trainer import Trainer

    def unisal():
        return UNISAL(cnn_widen_factor=0.25, cnn_last_channel=None,
                      rnn_input_channels=32, smoothing_ksize=11,
                      smoothing_rank=4)

    entry_points = {
        'OneShotClipProgram': lambda **kw: OneShotClipProgram(
            TransNetV1(f=2, d=16), unisal(), **kw),
        'FusedClipProgram': lambda **kw: FusedClipProgram(unisal(), **kw),
        'TransNetPredictor': lambda **kw: TransNetPredictor(
            TransNetV1(f=2, d=16), **kw),
        'IngestShotProgram': lambda **kw: IngestShotProgram(
            TransNetV1(f=2, d=16), sal_hw=(36, 64), **kw),
        'SaliencyPredictor': lambda **kw: SaliencyPredictor(unisal(), **kw),
        'make_mesh': lambda **kw: make_mesh(**kw),
        'ShardedOneShot': lambda **kw: ShardedOneShot(
            make_mesh(**kw), TransNetV1(f=2, d=16), unisal()),
        'ShardedClipRunner': lambda **kw: ShardedClipRunner(
            make_mesh(**kw), unisal()),
        'ShardedSaliency': lambda **kw: ShardedSaliency(
            make_mesh(**kw), unisal()),
        'Trainer': lambda **kw: Trainer(model_cfg=dict(
            cnn_widen_factor=0.25, cnn_last_channel=None,
            rnn_input_channels=32, rnn_hidden_channels=32,
            smoothing_ksize=11, smoothing_rank=4), **kw),
    }
    assert resolve_device('cpu') == torch.device('cpu')
    for name, make in entry_points.items():
        assert make(device='cpu').device == torch.device('cpu'), name
    if torch.cuda.is_available():
        pytest.skip('a GPU is present: the no-GPU contract is moot')
    with pytest.raises(RuntimeError, match='CUDA'):
        resolve_device(None)
    for name, make in entry_points.items():
        with pytest.raises(RuntimeError, match='CUDA'):
            make()
        with pytest.raises(RuntimeError, match='CUDA'):
            make(device='cuda')
    for name, call in _host_entry_points(tmp_path).items():
        with pytest.raises(RuntimeError, match='CUDA'):
            call()


def _host_entry_points(tmp_path):
    """The streaming path's functions and the CLI, each called without a
    device (the GPU by default)."""
    import pickle

    import numpy as np

    from retargetvid_tpu_torch.cli import main
    from retargetvid_tpu_torch.config import sc_init_crop_params
    from retargetvid_tpu_torch.pipeline.crop import smart_vid_crop
    from retargetvid_tpu_torch.pipeline.geometry import run_geometry
    from retargetvid_tpu_torch.pipeline.ingest import (
        ingest_pickle,
        read_video_structure,
        segment_chunks,
    )

    cp = sc_init_crop_params()
    frames = np.zeros((4, 36, 64, 3), np.uint8)
    pkl = tmp_path / 'clip.pkl'
    with open(pkl, 'wb') as fp:
        pickle.dump({'fr': 30.0, 'frame_count': 4, 'w': 64, 'h': 36,
                     'frames': frames}, fp)
    info = {'fps': 30.0, 'frame_count': 4, 'width': 64, 'height': 36}

    def unused(*args):
        raise AssertionError('a model ran before the device was resolved')

    from retargetvid_tpu_torch import bench, mfu
    from retargetvid_tpu_torch.dryrun import entry

    return {
        'bench': bench.main,
        'mfu': lambda: mfu.main(['--reps', '1']),
        'dryrun.entry': entry,
        'segment_chunks': lambda: segment_chunks(
            info, [(frames, 0)], cp, unused, unused),
        'ingest_pickle': lambda: ingest_pickle(pkl, cp, unused),
        'smart_vid_crop': lambda: smart_vid_crop(
            pkl, cp, save_vid=False, saliency_fn=unused),
        'run_geometry': lambda: run_geometry(
            np.zeros((2, 8, 8), np.uint8), [0, 3], [[0, 3]], [[0, 1]], cp,
            fps=30.0, h_orig=36, w_orig=64, w_final=12, h_final=36, fc=4),
        'cli crop': lambda: main(['crop', str(pkl)]),
        'read_video_structure': lambda: read_video_structure(
            tmp_path / 'missing.mp4', cp, unused),
        'cli benchmark': lambda: main(['benchmark', '--videos',
                                       str(tmp_path)]),
        'cli benchmark --mesh': lambda: main(['benchmark', '--videos',
                                              str(tmp_path), '--mesh', '2']),
        'cli predict': lambda: main(['predict', str(tmp_path)]),
        'cli train': lambda: main(['train', '--train-dir',
                                   str(tmp_path / 'run')]),
        'cli score': lambda: main(['score', '--train-dir', str(tmp_path)]),
    }


def test_kernel_wrapper_has_no_fallback():
    """Only a CPU tensor takes the plain version; other devices raise, and
    the build raises without nvcc rather than falling back."""
    from retargetvid_tpu_torch.kernels import build
    from retargetvid_tpu_torch.kernels.postprocess import saliency_postprocess

    x = torch.zeros((1, 4, 4), device='meta')
    with pytest.raises(ValueError, match='device'):
        saliency_postprocess(x)
    if not torch.cuda.is_available():
        try:
            nvcc = build._nvcc()
        except RuntimeError as exc:
            assert 'nvcc' in str(exc)
        else:
            pytest.skip(f'nvcc present at {nvcc}')


@pytest.mark.cuda
def test_saliency_predictor_kernel_on_the_card(monkeypatch):
    """On the card ``SaliencyPredictor.predict`` launches the postprocess
    kernel once per chunk (3 for 81 frames at ``chunk=32``) and gives the
    maps of the plain version swapped in."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA GPU (run on the card: python -m pytest '
                    'tests/test_torch_import.py -m cuda --noconftest)')
    import numpy as np

    from retargetvid_tpu_torch.kernels.build import LAUNCHES
    from retargetvid_tpu_torch.kernels.postprocess import (
        saliency_postprocess_reference,
    )
    from retargetvid_tpu_torch.models.init import seeded_init_
    from retargetvid_tpu_torch.models.unisal import UNISAL
    from retargetvid_tpu_torch.pipeline import saliency

    monkeypatch.setattr(torch.backends.cudnn, 'allow_tf32', False)
    monkeypatch.setattr(torch.backends.cuda.matmul, 'allow_tf32', False)
    frames = np.random.default_rng(0).integers(
        0, 255, (81, 140, 250, 3)).astype(np.uint8)
    predictor = saliency.SaliencyPredictor(seeded_init_(UNISAL(), 1))
    LAUNCHES.clear()
    maps = predictor.predict(frames)
    assert LAUNCHES['saliency_postprocess'] == 3
    monkeypatch.setattr(saliency, 'saliency_postprocess',
                        saliency_postprocess_reference)
    plain = predictor.predict(frames)
    assert LAUNCHES['saliency_postprocess'] == 3
    assert maps.shape == (81, 140, 250) and maps.dtype == np.uint8
    assert np.array_equal(maps, plain)
