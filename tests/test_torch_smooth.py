"""UNISAL's smoothing tail: the plain version against the ops it replaces,
the launch plan, when the model takes the kernel, and the CUDA kernel
against a float64 evaluation of its formula (on a card only).

No JAX here, so the ``cuda`` tests run on a machine without it:
``python -m pytest tests/test_torch_smooth.py -m cuda --noconftest``.
"""

import math

import numpy as np
import pytest
import torch
from torch.nn import functional as F

torch.set_num_threads(1)

#: The static forward's tail on the bench clip: 96 picks of the 32x52
#: adaptation map to the 256x416 network input, 8 factors of 41 taps.
BENCH = ((96, 1, 32, 52), (256, 416))
#: ``predict_video``'s chunk: 6 frames of a 640x360 clip (the network
#: input is 256x416 there too).
CHUNK = ((6, 1, 32, 52), (256, 416))
#: Shapes beside them: a non-integer scale; frames narrower and lower than
#: the 41 taps; fewer rows out than in (the columns always upscale); one
#: frame of one pixel; an output wider than a tile and not a multiple of 8
#: wide.
SHAPES = (((2, 1, 45, 80), (360, 640)), ((3, 1, 4, 5), (20, 30)),
          ((2, 1, 12, 8), (9, 13)), ((1, 1, 1, 1), (7, 3)),
          ((2, 1, 9, 70), (37, 1000)))
#: A narrow UNISAL with the default smoothing (41 taps, rank 8).
NARROW = dict(cnn_widen_factor=0.25, cnn_last_channel=None,
              rnn_input_channels=32, rnn_hidden_channels=32)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA GPU (run on the card: python -m pytest '
                    'tests/test_torch_smooth.py -m cuda --noconftest)')
    return torch.device('cuda')


def _map(shape, seed, device='cpu'):
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=device) * 2.0


def _random_factors(r, k, seed, device='cpu'):
    """Seeded factors of any sign, not a Gaussian's."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn((r, 1, k, 1), generator=gen, device=device),
            torch.randn((1, r, 1, k), generator=gen, device=device))


def _gaussian_factors(r, k):
    """The init's rank-r factors of the k-tap Gaussian."""
    from retargetvid_tpu_torch.models.unisal import (
        factorize_smoothing_kernel,
        smoothing_kernel_init,
    )

    kv, kh, _ = factorize_smoothing_kernel(smoothing_kernel_init(k), r)
    return torch.from_numpy(kv), torch.from_numpy(kh)


def _todays_tail(x, kv, kh, out_hw):
    """The ops ``UNISAL.forward_with_hidden`` ran unsharded before the
    kernel."""
    from retargetvid_tpu_torch.ops.resize import resize

    up = resize(x, out_hw, 'nearest', channels_last=False).to(x.dtype)
    pad = kv.shape[2] // 2
    up = F.pad(up, (pad, pad, pad, pad), mode='replicate')
    up = F.conv2d(up, kv)
    return F.conv2d(up, kh)


@pytest.mark.parametrize('shape, out_hw', [CHUNK, *SHAPES])
@pytest.mark.parametrize('factors', ['gaussian', 'random'])
def test_plain_version_is_todays_tail(shape, out_hw, factors):
    """On the CPU the plain version is the ops it replaces, bit for bit, so
    the JAX parity tests see the same model."""
    from retargetvid_tpu_torch.kernels.smooth import smooth_reference

    kv, kh = (_gaussian_factors(8, 41) if factors == 'gaussian'
              else _random_factors(3, 11, seed=1))
    x = _map(shape, seed=2)
    assert torch.equal(smooth_reference(x, kv, kh, out_hw),
                       _todays_tail(x, kv, kh, out_hw))


@pytest.mark.parametrize('case', ['cpu', 'float64', 'two_channels',
                                  'not_dense', 'rank_17', 'even_taps',
                                  'taps_65', 'factor_shapes', 'downscale'])
def test_wrapper_refuses(case):
    """What the kernel does not take raises, the CPU included."""
    from retargetvid_tpu_torch.kernels.smooth import saliency_smooth

    x = _map((2, 1, 4, 6), seed=3)
    kv, kh = _random_factors(4, 9, seed=4)
    err, match = ValueError, None
    if case == 'cpu':
        match = 'CUDA device'
    elif case == 'float64':
        x, err, match = x.double(), TypeError, 'float32'
    elif case == 'two_channels':
        x, match = x.expand(2, 2, 4, 6).contiguous(), 'map'
    elif case == 'not_dense':
        x, match = x[..., ::2], 'dense'
    elif case == 'rank_17':
        kv, kh = _random_factors(17, 9, seed=4)
        match = 'factors'
    elif case == 'even_taps':
        kv, kh = _random_factors(4, 8, seed=4)
        match = 'factors'
    elif case == 'taps_65':
        kv, kh = _random_factors(4, 65, seed=4)
        match = 'factors'
    elif case == 'factor_shapes':
        kh, match = kh[:, :3].contiguous(), 'factors'
    elif case == 'downscale':
        x, match = _map((2, 1, 4, 30), seed=3), 'upscales'
    with pytest.raises(err, match=match):
        saliency_smooth(x, kv, kh, (16, 24))


@pytest.mark.parametrize('n, h, w, out_h, out_w, r, k, plan', [
    # The bench: one 416-wide tile per band of 16 rows, 16 bands a frame;
    # the 52 source columns staged; 46 KB.
    (96, 32, 52, 256, 416, 8, 41,
     dict(tile_w=416, tiles_x=1, bands=16, ctas=1536, n_ecols=52,
          sv=460, se=60, kp=44, smem_bytes=46800)),
    # As wide as its map, at the most factors and taps: the staged source
    # would not fit beside a 416-wide tile, so the tile narrows to 200.
    (1, 8, 416, 64, 416, 16, 63,
     dict(tile_w=200, tiles_x=3, bands=4, ctas=12, n_ecols=262, sv=268,
          se=84, kp=64, smem_bytes=114760)),
    # Wider than a tile: three tiles.
    (2, 9, 70, 37, 1000, 8, 41,
     dict(tile_w=416, tiles_x=3, bands=3, ctas=18, n_ecols=34, sv=460,
          se=60, kp=44, smem_bytes=42480)),
])
def test_launch_plan(n, h, w, out_h, out_w, r, k, plan):
    from retargetvid_tpu_torch.kernels.smooth import launch_plan

    assert launch_plan(n, h, w, out_h, out_w, r, k)._asdict() == plan


@pytest.mark.parametrize('k', [1, 3, 41, 63])
def test_launch_plan_stages_every_column_it_reads(k):
    """For every tile of a range of scales, the source column of each padded
    column (the nearest rule, as the kernel computes it) lies among the
    ``n_ecols`` the plan stages, and two CTAs fit on an SM."""
    from retargetvid_tpu_torch.kernels.smooth import SMEM_BUDGET, launch_plan

    for w, out_w in ((52, 416), (80, 640), (45, 360), (7, 1000), (5, 30),
                     (8, 13), (500, 640), (416, 416), (3, 3), (1, 9)):
        pl = launch_plan(1, 8, w, 64, out_w, 16, k)
        assert pl.smem_bytes <= SMEM_BUDGET
        scale, pad = w / out_w, k // 2

        def col(x):
            return min(math.floor(min(max(x - pad, 0), out_w - 1) * scale),
                       w - 1)
        for tile in range(pl.tiles_x):
            x0 = tile * pl.tile_w
            cols = [col(x0 + x) for x in range(pl.tile_w + k - 1)]
            staged = [c - cols[0] for c in cols]
            assert 0 <= min(staged) and max(staged) < pl.n_ecols, (w, out_w)


class _KernelCalls:
    """Records the kernel's calls (answered by the plain version) and makes
    every tensor report ``is_cuda``, so the model's choice can be seen on
    the CPU."""

    def __init__(self, monkeypatch):
        from retargetvid_tpu_torch.kernels import smooth

        self.calls = []

        def launch(x, kv, kh, out_hw):
            self.calls.append((tuple(x.shape), tuple(kv.shape), out_hw))
            return smooth.smooth_reference(x, kv, kh, out_hw)

        monkeypatch.setattr(smooth, 'saliency_smooth', launch)
        monkeypatch.setattr(torch.Tensor, 'is_cuda',
                            property(lambda self: True))


@pytest.mark.parametrize('case', ['inference', 'grad', 'shard', 'float64',
                                  'rank_17', 'cpu', 'full_kernel'])
def test_helper_takes_the_kernel_only_for_inference(case, monkeypatch):
    """``smoothing_on_kernel`` is true on a CUDA map with no gradient
    recorded, outside mesh training, for a model with factored smoothing;
    false otherwise.  A float64 map, or factors the kernel does not take,
    still go to the kernel, whose wrapper refuses them: nothing on the
    card falls back to the ops for them."""
    import contextlib

    from retargetvid_tpu_torch.kernels.smooth import saliency_smooth
    from retargetvid_tpu_torch.models.unisal import smoothing_on_kernel
    from retargetvid_tpu_torch.parallel import shard

    if case != 'cpu':
        monkeypatch.setattr(torch.Tensor, 'is_cuda',
                            property(lambda self: True))
    x = _map((2, 1, 4, 6), seed=5)
    kv, kh = _random_factors(17 if case == 'rank_17' else 8, 41, seed=6)
    if case == 'float64':
        x = x.double()
    rank = None if case == 'full_kernel' else kv.shape[0]
    ctx = (shard.active(object()) if case == 'shard'
           else contextlib.nullcontext())
    with ctx, torch.set_grad_enabled(case == 'grad'):
        assert smoothing_on_kernel(x, rank) == (
            case in ('inference', 'float64', 'rank_17'))
    if case in ('float64', 'rank_17'):
        err, match = ((TypeError, 'float32') if case == 'float64'
                      else (ValueError, 'factors'))
        with pytest.raises(err, match=match):
            saliency_smooth(x, kv, kh, (32, 48))


@pytest.mark.parametrize('case', ['inference', 'grad', 'full_kernel'])
def test_unisal_takes_the_kernel_once_a_forward(case, monkeypatch):
    """The narrow UNISAL's static forward, as if on a card, hands the kernel
    its adaptation map, the source's factors and the input size once, and
    gives what the CPU's ops give bit for bit; under grad, or with
    ``smoothing_rank=None`` (the full 41x41 kernel), it calls nothing."""
    from retargetvid_tpu_torch.models.init import seeded_init_
    from retargetvid_tpu_torch.models.unisal import UNISAL

    cfg = dict(NARROW, smoothing_rank=None if case == 'full_kernel' else 8)
    model = seeded_init_(UNISAL(**cfg), 1).eval()
    x = torch.from_numpy(np.random.default_rng(7).uniform(
        0, 1, (2, 1, 64, 96, 3)).astype(np.float32))
    with torch.set_grad_enabled(case == 'grad'):
        want = model(x, source='SALICON')
        kernel = _KernelCalls(monkeypatch)
        got = model(x, source='SALICON')
    assert torch.equal(got, want)
    if case == 'inference':
        assert kernel.calls == [((2, 1, 8, 12), (8, 1, 41, 1), (64, 96))]
    else:
        assert kernel.calls == []


def _exact(x, kv, kh, out_hw):
    """The formula in float64, on the tensors' device; and the sum of the
    terms' magnitudes, what float32 rounding is a share of."""
    from retargetvid_tpu_torch.kernels.smooth import smooth_reference

    x, kv, kh = x.double(), kv.double(), kh.double()
    return (smooth_reference(x, kv, kh, out_hw),
            smooth_reference(x.abs(), kv.abs(), kh.abs(), out_hw))


def _kernel_vs_exact(shape, out_hw, kv, kh, device, seed):
    """The kernel within float32 FMA's worst case of the float64 value: a
    chain of k vertical FMAs, then r k horizontal ones, each rounding by at
    most 2^-24 of a running sum no larger than the terms' magnitudes:
    k (1 + r) / 2 units of 2^-23 of that sum."""
    from retargetvid_tpu_torch.kernels.build import LAUNCHES
    from retargetvid_tpu_torch.kernels.smooth import saliency_smooth

    kv, kh = kv.to(device), kh.to(device)
    x = _map(shape, seed, device)
    launches = LAUNCHES['saliency_smooth']
    got = saliency_smooth(x, kv, kh, out_hw)
    torch.cuda.synchronize()
    assert LAUNCHES['saliency_smooth'] == launches + 1
    assert got.shape == (shape[0], 1, *out_hw) and got.is_contiguous()
    exact, size = _exact(x, kv, kh, out_hw)
    r, k = kv.shape[0], kv.shape[2]
    tol = k * (1 + r) / 2 * 2.0 ** -23 * size
    err = (got.double() - exact).abs()
    assert bool((err <= tol).all()), float((err / size.clamp(min=1e-300))
                                           .max())


@pytest.mark.cuda
@pytest.mark.parametrize('shape, out_hw', [BENCH, CHUNK])
@pytest.mark.parametrize('source', ['DHF1K', 'SALICON'])
def test_kernel_matches_exact_with_the_models_factors(cuda_device, shape,
                                                      out_hw, source):
    from retargetvid_tpu_torch.models.unisal import UNISAL

    model = UNISAL(**NARROW)
    suffix = f'_{source.lower()}'
    kv = getattr(model, f'smoothing_v{suffix}').detach()
    kh = getattr(model, f'smoothing_h{suffix}').detach()
    _kernel_vs_exact(shape, out_hw, kv, kh, cuda_device, seed=10)


@pytest.mark.cuda
@pytest.mark.parametrize('shape, out_hw', [BENCH, CHUNK, *SHAPES])
@pytest.mark.parametrize('r, k', [(1, 41), (8, 41), (16, 63), (3, 1),
                                  (2, 9)])
def test_kernel_matches_exact_with_random_factors(cuda_device, shape, out_hw,
                                                  r, k):
    kv, kh = _random_factors(r, k, seed=11)
    _kernel_vs_exact(shape, out_hw, kv, kh, cuda_device, seed=12)


@pytest.mark.cuda
def test_kernel_fails_loudly(cuda_device):
    """A launch the C side refuses raises with its error and counts
    nothing."""
    from retargetvid_tpu_torch.kernels import smooth
    from retargetvid_tpu_torch.kernels.build import LAUNCHES, launch

    x = _map((2, 1, 4, 6), 13, cuda_device)
    kv, kh = _random_factors(2, 5, 14, cuda_device)
    out = torch.empty((2, 1, 16, 24), device=cuda_device)
    launches = LAUNCHES['saliency_smooth']
    with pytest.raises(RuntimeError, match='CUDA error'):
        launch('saliency_smooth', smooth._SIGNATURES, 'rtv_saliency_smooth',
               x.device, x.data_ptr(), kv.data_ptr(), kh.data_ptr(),
               out.data_ptr(), 2, 4, 6, 16, 24, 2, 5, 12, 6, 68, 52, 8)
    assert LAUNCHES['saliency_smooth'] == launches


@pytest.mark.cuda
def test_one_launch_per_forward(cuda_device):
    """A static forward and a ConvGRU chunk of the narrow UNISAL each
    launch the kernel once; a forward with gradients recorded, and a model
    with the full 41x41 kernel, launch it never."""
    from retargetvid_tpu_torch.kernels.build import LAUNCHES
    from retargetvid_tpu_torch.models.init import seeded_init_
    from retargetvid_tpu_torch.models.unisal import UNISAL

    model = seeded_init_(UNISAL(**NARROW), 1).to(cuda_device).eval()
    x = torch.from_numpy(np.random.default_rng(15).uniform(
        0, 1, (1, 6, 64, 96, 3)).astype(np.float32)).to(cuda_device)
    launches = LAUNCHES['saliency_smooth']
    with torch.inference_mode():
        model(x[:, :1], source='SALICON')
        assert LAUNCHES['saliency_smooth'] == launches + 1
        model(x, source='DHF1K', static=False)
        assert LAUNCHES['saliency_smooth'] == launches + 2
    model(x, source='DHF1K', static=False)
    assert LAUNCHES['saliency_smooth'] == launches + 2
    full = seeded_init_(UNISAL(**NARROW, smoothing_rank=None), 1).to(
        cuda_device).eval()
    with torch.inference_mode():
        full(x[:, :1], source='SALICON')
    assert LAUNCHES['saliency_smooth'] == launches + 2


@pytest.mark.cuda
def test_static_forward_kernel_vs_ops(cuda_device, monkeypatch):
    """The full-width static forward at the bench's input with the kernel
    against the same forward with the tail as the ops, float32 with TF32
    off: log-probabilities within 1e-4."""
    from retargetvid_tpu_torch import bench
    from retargetvid_tpu_torch.models import unisal

    _, un = bench.build_models()
    un = un.to(cuda_device).float().eval()
    x = torch.from_numpy(np.random.default_rng(16).uniform(
        0, 1, (8, 1, 256, 416, 3)).astype(np.float32)).to(cuda_device)
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.inference_mode():
            got = un(x, target_size=(140, 250), source='SALICON')
            monkeypatch.setattr(unisal, 'smoothing_on_kernel',
                                lambda *a: False)
            want = un(x, target_size=(140, 250), source='SALICON')
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
