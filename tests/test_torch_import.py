"""The PyTorch port imports neither JAX nor the JAX package, and its entry
points never fall back to the CPU or to the plain kernel versions."""

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


def test_port_imports_no_jax():
    mods = _port_modules()
    assert len(mods) >= 20, mods
    code = ('import importlib, sys\n'
            f'for m in {mods!r}: importlib.import_module(m)\n'
            'import chip_smoke, kernel_turns\n'
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'flax' or m.startswith('flax.') "
            "or m == 'retargetvid_tpu' or m.startswith('retargetvid_tpu.'))\n"
            'print(bad)\n'
            'sys.exit(1 if bad else 0)\n')
    res = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_entry_points_need_a_gpu_unless_asked_for_cpu():
    from retargetvid_tpu_torch.device import resolve_device
    from retargetvid_tpu_torch.models.transnet import (
        IngestShotProgram,
        TransNetPredictor,
        TransNetV1,
    )
    from retargetvid_tpu_torch.models.unisal import UNISAL
    from retargetvid_tpu_torch.pipeline.fused import FusedClipProgram
    from retargetvid_tpu_torch.pipeline.oneshot import OneShotClipProgram

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
