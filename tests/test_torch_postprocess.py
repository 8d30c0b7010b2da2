"""Saliency postprocess: the port's plain version vs JAX, and the CUDA
kernel vs the plain version (on a card only)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

torch.set_num_threads(1)


def _log_maps(seed, t=5, h=32, w=128):
    """Seeded log-probability maps: spatial log-softmax of random logits,
    plus the raw logits the JAX kernel test uses."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 2, (t, h * w))
    logp = logits - np.log(np.exp(logits).sum(axis=1, keepdims=True))
    return [logp.reshape(t, h, w).astype(np.float32),
            rng.normal(-8, 2, (t, h, w)).astype(np.float32)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA GPU (run on the card: '
                    'python -m pytest tests/test_torch_postprocess.py)')
    return torch.device('cuda')


def _report(name, out, ref):
    diff = np.abs(out.astype(int) - ref.astype(int))
    print(f'{name}: max |diff| {diff.max()} LSB (tolerance 1), '
          f'{(diff > 0).mean():.4%} of pixels differ')
    return diff


@pytest.mark.parametrize('seed', [0, 1])
def test_plain_matches_jax_inline(seed):
    from retargetvid_tpu.ops.pallas_kernels import saliency_postprocess as jpp
    from retargetvid_tpu_torch.kernels.postprocess import (
        saliency_postprocess,
    )
    for x in _log_maps(seed):
        ref = np.asarray(jpp(jnp.asarray(x), use_pallas=False))
        out = saliency_postprocess(torch.from_numpy(x)).numpy()
        assert out.dtype == np.uint8 and out.shape == ref.shape
        # XLA's and torch's CPU exp may differ by an ulp.
        assert _report('plain vs JAX inline', out, ref).max() <= 1


def test_plain_matches_pallas_interpret():
    from retargetvid_tpu.ops.pallas_kernels import saliency_postprocess as jpp
    from retargetvid_tpu_torch.kernels.postprocess import (
        saliency_postprocess_reference,
    )
    x = _log_maps(2)[1]
    ref = np.asarray(jpp(jnp.asarray(x), use_pallas=True, interpret=True))
    out = saliency_postprocess_reference(torch.from_numpy(x)).numpy()
    assert _report('plain vs Pallas interpret', out, ref).max() <= 1


def test_empty_and_constant_frames():
    from retargetvid_tpu_torch.kernels.postprocess import saliency_postprocess
    x = np.stack([np.full((32, 128), -np.inf, np.float32),
                  np.full((32, 128), -3.0, np.float32)])
    out = saliency_postprocess(torch.from_numpy(x)).numpy()
    assert (out[0] == 0).all()
    assert (out[1] == 255).all()


@pytest.mark.cuda
def test_cuda_kernel_matches_plain(cuda_device):
    from retargetvid_tpu_torch.kernels.postprocess import (
        saliency_postprocess,
        saliency_postprocess_reference,
    )
    x = torch.from_numpy(_log_maps(3, t=96, h=140, w=250)[0]).to(cuda_device)
    x[3] = -float('inf')
    before = saliency_postprocess.launches
    out = saliency_postprocess(x)
    torch.cuda.synchronize()
    assert saliency_postprocess.launches == before + 1
    ref = saliency_postprocess_reference(x)
    diff = _report('CUDA kernel vs plain', out.cpu().numpy(),
                   ref.cpu().numpy())
    assert diff.max() <= 1
    assert (out[3] == 0).all()
    with pytest.raises(TypeError):
        saliency_postprocess(x.double())
    with pytest.raises(ValueError):
        saliency_postprocess(x.transpose(1, 2))
