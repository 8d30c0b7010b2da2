"""Saliency postprocess: the port's plain version vs JAX, the kernel's
launch plan, and the CUDA kernel vs the plain version (on a card only).

JAX is imported inside the tests that use it, so the ``cuda`` tests run on
a machine without it: ``python -m pytest tests/test_torch_postprocess.py
-m cuda --noconftest``.
"""

import numpy as np
import pytest
import torch

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
    import jax.numpy as jnp

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
    import jax.numpy as jnp

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


@pytest.mark.parametrize('t, hw, cluster, on_chip', [
    (96, 140 * 250, 4, True),         # the main path's shape
    (32, 140 * 250, 8, True),         # the streaming path's chunk
    (1, 140 * 250, 8, True),          # one frame
    (3, 37 * 53, 1, True),            # ragged: hw % 4 != 0
    (2, 720 * 1280, 8, False),        # more than a cluster holds on chip
    (5, 32 * 128, 4, True),
])
def test_launch_plan(t, hw, cluster, on_chip):
    """The kernel's launch plan: its CTAs cover every element of every
    frame exactly once, within the card's limits."""
    from retargetvid_tpu_torch.kernels.postprocess import launch_plan
    plan = launch_plan(t, hw)
    assert (plan.cluster, plan.on_chip) == (cluster, on_chip)
    assert plan.cluster <= 8 and plan.ctas == t * plan.cluster
    assert plan.smem_bytes <= 232448
    assert plan.vec == (hw % 4 == 0)
    assert plan.slice % 4 == 0            # each slice starts 16-byte aligned
    bounds = plan.cta_bounds(hw)
    hits = np.zeros(t * hw, np.int32)
    for cta in range(plan.ctas):          # as the kernel indexes its grid
        frame, rank = divmod(cta, plan.cluster)
        lo, hi = bounds[rank]
        hits[frame * hw + lo:frame * hw + hi] += 1
    assert (hits == 1).all()


#: The kernel's shapes on the card: the main path's, the streaming path's
#: chunk, one frame, ragged (hw % 4 != 0), larger than a cluster holds on
#: chip, small frames.
CUDA_SHAPES = [(96, 140, 250), (32, 140, 250), (1, 140, 250), (3, 37, 53),
               (2, 720, 1280), (5, 32, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize('shape', CUDA_SHAPES,
                         ids=['x'.join(map(str, s)) for s in CUDA_SHAPES])
def test_cuda_kernel_matches_plain(cuda_device, shape):
    from retargetvid_tpu_torch.kernels.postprocess import (
        saliency_postprocess,
        saliency_postprocess_reference,
    )
    t, h, w = shape
    x = torch.from_numpy(_log_maps(3, t=t, h=h, w=w)[0]).to(cuda_device)
    if t >= 2:
        x[t - 1] = -float('inf')
    if t >= 3:
        x[1] = -3.0
    inputs = [x]
    if shape == CUDA_SHAPES[0]:
        # A contiguous view 4 bytes past a 16-byte boundary.
        flat = torch.empty(x.numel() + 1, device=cuda_device)
        inputs.append(flat[1:].view(shape).copy_(x))
        # Wide ranges for the division: exp over many decades, subnormal
        # exp values beside normal maxima, maxima above 2^125.
        rng = np.random.default_rng(4)
        inputs += [torch.from_numpy((rng.normal(0, 1, shape) * s + o)
                                    .astype(np.float32)).to(cuda_device)
                   for s, o in ((20, 0), (1, -87), (3, -95), (30, 60))]
    for xi in inputs:
        before = saliency_postprocess.launches
        out = saliency_postprocess(xi)
        torch.cuda.synchronize()
        assert saliency_postprocess.launches == before + 1
        ref = saliency_postprocess_reference(xi)
        diff = _report(f'CUDA kernel vs plain {shape}', out.cpu().numpy(),
                       ref.cpu().numpy())
        assert diff.max() == 0            # a max is exact in any order
    out = saliency_postprocess(x)
    if t >= 2:
        assert (out[t - 1] == 0).all()
    if t >= 3:
        assert (out[1] == 255).all()
    with pytest.raises(TypeError):
        saliency_postprocess(x.double())
    with pytest.raises(ValueError):
        saliency_postprocess(x.transpose(1, 2))
