"""Inference BatchNorm epilogue: the plain version against the ops it
replaces, the launch plan, when the model's helper takes the kernel, and
the CUDA kernel against its plain version (on a card only).

No JAX here, so the ``cuda`` tests run on a machine without it:
``python -m pytest tests/test_torch_bn_act.py -m cuda --noconftest``.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

EPS = 1e-5
#: The three forms UNISAL's static forward needs: BatchNorm + ReLU6 (42
#: calls), BatchNorm alone (12) and BatchNorm + the residual add (10).
FORMS = {'relu6': (True, False), 'alone': (False, False),
         'residual': (False, True)}
#: Channels 32, 144, 1280 and 1296 (all the static forward's), H*W even and
#: odd, and C and H*W both not multiples of 4 (single floats either way).
SHAPES = ((4, 32, 16, 26), (3, 144, 7, 13), (2, 1280, 8, 13),
          (2, 1296, 8, 13), (3, 30, 5, 7))
#: Every (C, H, W) a BatchNorm of the static forward sees at the bench
#: clip's 256x416 input, 96 picks.
STATIC_SHAPES = sorted({
    (32, 128, 208), (16, 128, 208), (96, 128, 208), (24, 128, 208),
    (144, 64, 104), (24, 64, 104), (32, 64, 104), (192, 32, 52),
    (32, 32, 52), (64, 32, 52), (384, 16, 26), (64, 16, 26), (96, 16, 26),
    (576, 16, 26), (160, 16, 26), (960, 8, 13), (160, 8, 13), (320, 8, 13),
    (1280, 8, 13), (320, 16, 26), (128, 16, 26), (128, 32, 52),
    (1296, 8, 13), (256, 8, 13), (768, 16, 26), (384, 32, 52)})
#: Rounding allowed between the kernel and the plain version, relative to
#: the size of the terms that either rounds (``_bound``): float32 rounding
#: of the scale and shift and of the two or three operations after them,
#: on both sides, some 16 ulp.
REL_TOL = 2.0 ** -20


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA GPU (run on the card: python -m pytest '
                    'tests/test_torch_bn_act.py -m cuda --noconftest)')
    return torch.device('cuda')


def _stats(c, seed, device='cpu'):
    """Seeded running mean, running variance, weight and bias of ``c``
    channels."""
    rng = np.random.default_rng(seed)
    arrays = (rng.normal(0.0, 1.0, c), rng.uniform(0.1, 3.0, c),
              rng.normal(1.0, 0.5, c), rng.normal(0.0, 0.5, c))
    return [torch.from_numpy(a.astype(np.float32)).to(device)
            for a in arrays]


def _input(shape, layout, seed, device='cpu'):
    """Seeded (N, C, H, W) values in ``layout``, spread past ReLU6's 0 and
    6 once normalised."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(shape, generator=gen, device=device) * 3.0
    if layout == 'nhwc':
        x = x.contiguous(memory_format=torch.channels_last)
    return x


def _todays_composition(x, stats, relu6, residual):
    """The ops the model ran before the kernel: ``batch_norm_eval``, then
    ``relu6``, then ``x + h``."""
    from retargetvid_tpu_torch.models import layers

    bn = layers.BatchNorm(x.shape[1]).to(x.device)
    with torch.no_grad():
        for buf, v in zip((bn.running_mean, bn.running_var, bn.weight,
                           bn.bias), stats):
            buf.copy_(v)
    y = layers.batch_norm_eval(bn, x)
    if relu6:
        y = layers.relu6(y)
    return y if residual is None else residual + y


@pytest.mark.parametrize('layout', ['nchw', 'nhwc'])
@pytest.mark.parametrize('form', sorted(FORMS))
def test_plain_version_is_todays_composition(form, layout):
    """On the CPU the wrapper's plain version equals the ops it replaces bit
    for bit, in the input's layout."""
    from retargetvid_tpu_torch.kernels.bn_act import bn_act

    relu6, with_res = FORMS[form]
    for shape in SHAPES:
        x = _input(shape, layout, seed=1)
        res = _input(shape, layout, seed=2) if with_res else None
        stats = _stats(shape[1], seed=3)
        with torch.no_grad():
            got = bn_act(x, *stats, EPS, relu6=relu6, residual=res)
            want = _todays_composition(x, stats, relu6, res)
        assert torch.equal(got, want)
        assert got.stride() == x.stride()


@pytest.mark.parametrize('shape, layout, aligned, mode, inner, units, ctas', [
    # The static forward's largest call: float4 over four channels, the
    # grid one full wave (8 CTAs on each of 132 SMs).
    ((96, 96, 128, 208), 'nhwc', True, 0, 1, 61341696, 1056),
    ((96, 96, 128, 208), 'nchw', True, 1, 26624, 61341696, 1056),
    # H*W = 91: NCHW takes single floats, channels-last float4.
    ((3, 144, 7, 13), 'nchw', True, 2, 91, 39312, 154),
    ((3, 144, 7, 13), 'nhwc', True, 0, 1, 9828, 39),
    ((3, 30, 5, 7), 'nhwc', True, 2, 1, 3150, 13),
    # An unaligned pointer: single floats.
    ((2, 1296, 8, 13), 'nhwc', False, 2, 1, 269568, 1053),
    # 6144 channels fill 48 KB of shared memory: 4 CTAs an SM.
    ((8, 6144, 32, 32), 'nhwc', True, 0, 1, 12582912, 528),
])
def test_launch_plan(shape, layout, aligned, mode, inner, units, ctas):
    from retargetvid_tpu_torch.kernels.bn_act import launch_plan

    plan = launch_plan(shape, layout, aligned)
    assert (plan.mode, plan.inner, plan.units, plan.ctas) == (
        mode, inner, units, ctas)
    assert plan.smem_bytes == 8 * shape[1]


@pytest.mark.parametrize('case', ['float64', 'not_dense', 'five_dims',
                                  'residual_strides', 'residual_shape',
                                  'buffer_shape', 'too_many_channels'])
def test_wrapper_refuses(case):
    """What the kernel does not take raises, on every device."""
    from retargetvid_tpu_torch.kernels.bn_act import bn_act

    x = _input((2, 8, 4, 6), 'nhwc', seed=4)
    stats = _stats(8, seed=5)
    res = None
    err = ValueError
    if case == 'float64':
        x, err = x.double(), TypeError
    elif case == 'not_dense':
        x = x[..., ::2]
    elif case == 'five_dims':
        x = x[None]
    elif case == 'residual_strides':
        res = x.contiguous()                       # NCHW beside an NHWC x
    elif case == 'residual_shape':
        res = x[:1]
    elif case == 'buffer_shape':
        stats[1] = stats[1][:4]
    elif case == 'too_many_channels':
        x = torch.zeros((1, 6145, 1, 1))
        stats = _stats(6145, seed=5)
    with pytest.raises(err):
        bn_act(x, *stats, EPS, relu6=True, residual=res)
    with pytest.raises(ValueError, match='unsupported device'):
        bn_act(torch.zeros((1, 8, 2, 2), device='meta'),
               *[s.to('meta') for s in _stats(8, seed=5)], EPS)


class _KernelCalls:
    """Records the kernel's calls (checked as the wrapper checks them, then
    answered by the plain version) and, with ``fake_cuda``, makes every
    tensor report ``is_cuda``, so the helper's choice can be seen on the
    CPU."""

    def __init__(self, monkeypatch, fake_cuda):
        from retargetvid_tpu_torch.kernels import bn_act as kernel

        self.calls = 0

        def launch(x, mean, var, gamma, beta, eps, relu6=False,
                   residual=None):
            self.calls += 1
            kernel._check(x, mean, var, gamma, beta, residual)
            return kernel.bn_act_reference(x, mean, var, gamma, beta, eps,
                                           relu6, residual)

        monkeypatch.setattr(kernel, 'bn_act', launch)
        if fake_cuda:
            monkeypatch.setattr(torch.Tensor, 'is_cuda',
                                property(lambda self: True))


@pytest.mark.parametrize('case', ['inference', 'cpu', 'grad', 'bn_train',
                                  'shard', 'float64', 'not_dense'])
def test_helper_takes_the_kernel_only_for_inference(case, monkeypatch):
    """``layers.bn_act`` takes the kernel on a CUDA tensor with no gradient
    recorded and the BatchNorm in eval mode, a mesh shard's rows too, and
    the kernel raises on a CUDA tensor it does not take; in any other case
    the ops it ran before, with the same result."""
    import contextlib

    from retargetvid_tpu_torch.models import layers
    from retargetvid_tpu_torch.parallel import shard

    kernel = _KernelCalls(monkeypatch, fake_cuda=case != 'cpu')
    bn = layers.DomainBN(8, ('DHF1K', 'SALICON'))
    stats = _stats(8, seed=6)
    with torch.no_grad():
        for buf, v in zip((bn.bn_salicon.running_mean,
                           bn.bn_salicon.running_var, bn.bn_salicon.weight,
                           bn.bn_salicon.bias), stats):
            buf.copy_(v)
    x = _input((2, 8, 4, 6), 'nhwc', seed=7)
    res = _input((2, 8, 4, 6), 'nchw', seed=8)     # laid out as x first
    grad = case == 'grad'
    if case == 'bn_train':
        layers.set_bn_train(bn, True)
    if case == 'float64':
        x, res = x.double(), res.double()
        bn.double()
    if case == 'not_dense':
        x, res = x[..., ::2], res[..., ::2]
    ctx = (shard.active(object()) if case == 'shard'
           else contextlib.nullcontext())
    with ctx, torch.set_grad_enabled(grad):
        if case in ('float64', 'not_dense'):
            with pytest.raises((TypeError, ValueError)):
                layers.bn_act(bn, x, 'SALICON', layers.relu6, residual=res)
            assert kernel.calls == 1
            return
        got = layers.bn_act(bn, x, 'SALICON', layers.relu6, residual=res)
        want = res + layers.relu6(bn(x, 'SALICON'))
    assert kernel.calls == (1 if case in ('inference', 'shard') else 0)
    if case != 'bn_train':              # train mode moved the statistics
        assert torch.equal(got, want)


def test_helper_names_the_source():
    from retargetvid_tpu_torch.models import layers

    bn = layers.DomainBN(8, ('DHF1K',))
    with pytest.raises(ValueError, match='unknown source'):
        layers.bn_act(bn, torch.zeros((1, 8, 2, 2)), 'SALICON')


@pytest.mark.parametrize('static', [True, False])
def test_unisal_unchanged_on_the_cpu(static, monkeypatch):
    """The narrow UNISAL's forward on the CPU, static and with its ConvGRU,
    equals the forward with every BatchNorm run as the separate ops of
    before, bit for bit."""
    from conftest import TINY_UNISAL_CFG
    from retargetvid_tpu_torch.models import unisal
    from retargetvid_tpu_torch.models.init import seeded_init_

    model = _random_stats_(seeded_init_(unisal.UNISAL(**TINY_UNISAL_CFG),
                                        1), seed=0)
    x = torch.from_numpy(np.random.default_rng(9).uniform(
        0, 1, (1, 1 if static else 3, 64, 96, 3)).astype(np.float32))
    with torch.inference_mode():
        got = model(x, source='DHF1K', static=static)

    _separate_ops(monkeypatch)
    with torch.inference_mode():
        want = model(x, source='DHF1K', static=static)
    assert torch.equal(got, want)


def _separate_ops(monkeypatch):
    """Every BatchNorm of the model run as the separate ops of before the
    kernel: ``apply_bn``, then ``act``, then the residual add."""
    from retargetvid_tpu_torch.models import layers, unisal

    def before(bn, x, source, act=None, residual=None):
        y = layers.apply_bn(bn, x, source)
        y = y if act is None else act(y)
        return y if residual is None else residual + y

    monkeypatch.setattr(layers, 'bn_act', before)
    monkeypatch.setattr(unisal, 'bn_act', before)


def _bound(x, stats, res):
    """The size of the terms of each element under either order of the
    arithmetic, the kernel's ``x s + t`` and cuDNN's ``(x - mean) s +
    beta``: |x s| + |mean s| + |beta| + |r|, s in float64."""
    mean, var, gamma, beta = (v.double()[None, :, None, None] for v in stats)
    s = (gamma / torch.sqrt(var + EPS)).abs()
    size = x.double().abs() * s + mean.abs() * s + beta.abs()
    return size if res is None else size + res.double().abs()


def _kernel_vs_plain(shape, layout, form, device, seed):
    from retargetvid_tpu_torch.kernels.bn_act import bn_act, bn_act_reference
    from retargetvid_tpu_torch.kernels.build import LAUNCHES

    relu6, with_res = FORMS[form]
    x = _input(shape, layout, seed, device)
    res = _input(shape, layout, seed + 1, device) if with_res else None
    stats = _stats(shape[1], seed + 2, device)
    launches = LAUNCHES['bn_act']
    got = bn_act(x, *stats, EPS, relu6=relu6, residual=res)
    want = bn_act_reference(x, *stats, EPS, relu6=relu6, residual=res)
    torch.cuda.synchronize()
    assert LAUNCHES['bn_act'] == launches + 1
    assert got.stride() == x.stride()
    err = (got.double() - want.double()).abs()
    assert bool((err <= REL_TOL * _bound(x, stats, res)).all()), \
        float((err / _bound(x, stats, res).clamp(min=1e-30)).max())


@pytest.mark.cuda
@pytest.mark.parametrize('layout', ['nchw', 'nhwc'])
@pytest.mark.parametrize('form', sorted(FORMS))
@pytest.mark.parametrize('shape', SHAPES)
def test_kernel_matches_plain(cuda_device, shape, layout, form):
    _kernel_vs_plain(shape, layout, form, cuda_device, seed=10)


@pytest.mark.cuda
@pytest.mark.parametrize('layout', ['nchw', 'nhwc'])
@pytest.mark.parametrize('form', sorted(FORMS))
def test_kernel_matches_plain_at_the_static_shapes(cuda_device, form,
                                                   layout):
    for i, chw in enumerate(STATIC_SHAPES):
        _kernel_vs_plain((96, *chw), layout, form, cuda_device, seed=20 + i)


@pytest.mark.cuda
def test_kernel_keeps_nan_and_fails_loudly(cuda_device):
    """NaN stays NaN through ReLU6 as through ``torch.clamp``; an unaligned
    view takes single floats; a launch the C side refuses raises with its
    error."""
    from retargetvid_tpu_torch.kernels import bn_act as kernel
    from retargetvid_tpu_torch.kernels.build import LAUNCHES, launch

    stats = _stats(8, 30, cuda_device)
    x = _input((2, 8, 4, 6), 'nhwc', 31, cuda_device)
    x[0, 0, 0, 0] = float('nan')
    got = kernel.bn_act(x, *stats, EPS, relu6=True)
    assert torch.equal(got.isnan(), x.isnan())
    flat = torch.randn(2 * 8 * 4 * 6 + 1, device=cuda_device)[1:]
    view = flat.view(2, 4, 6, 8).permute(0, 3, 1, 2)    # 4 bytes off
    assert kernel.layout_of(view) == 'nhwc'
    assert kernel.launch_plan(tuple(view.shape), 'nhwc',
                              view.data_ptr() % 16 == 0).mode == kernel.SCALAR
    assert torch.allclose(kernel.bn_act(view, *stats, EPS),
                          kernel.bn_act_reference(view, *stats, EPS),
                          rtol=1e-5, atol=1e-5)
    out = torch.empty_like(x)
    launches = LAUNCHES['bn_act']
    with pytest.raises(RuntimeError, match='CUDA error'):
        launch('bn_act', kernel._SIGNATURES, 'rtv_bn_act', x.device,
               x.data_ptr(), None, out.data_ptr(),
               *(s.data_ptr() for s in stats), EPS, x.numel(), 8, 1,
               kernel.NCHW_VEC, 1, 1)
    assert LAUNCHES['bn_act'] == launches


def _random_stats_(model, seed):
    """Every BatchNorm of ``model`` given seeded statistics, weight and
    bias."""
    from retargetvid_tpu_torch.models.layers import BatchNorm

    with torch.no_grad():
        for i, m in enumerate(model.modules()):
            if isinstance(m, BatchNorm):
                stats = _stats(m.num_features, seed + i,
                               m.running_mean.device)
                for buf, v in zip((m.running_mean, m.running_var, m.weight,
                                   m.bias), stats):
                    buf.copy_(v)
    return model


@pytest.mark.cuda
def test_static_forward_kernel_vs_plain(cuda_device, monkeypatch):
    """The full-width static forward with the kernel against the same
    forward with every BatchNorm as the separate ops, on the same weights,
    float32 with TF32 off: log-probabilities within 1e-4 (some 1e-5 of
    their size)."""
    from retargetvid_tpu_torch import bench
    from retargetvid_tpu_torch.kernels.build import LAUNCHES

    _, un = bench.build_models()
    un = _random_stats_(un.to(cuda_device).float(), seed=40)
    x = torch.from_numpy(np.random.default_rng(41).uniform(
        0, 1, (8, 1, 256, 416, 3)).astype(np.float32)).to(cuda_device)
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.inference_mode():
            launches = LAUNCHES['bn_act']
            got = un(x, target_size=(140, 250), source='SALICON')
            assert LAUNCHES['bn_act'] == launches + 64
            _separate_ops(monkeypatch)
            want = un(x, target_size=(140, 250), source='SALICON')
            assert LAUNCHES['bn_act'] == launches + 64
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
def test_64_launches_per_dispatch(cuda_device):
    """A one-shot ICIP ``dispatch`` launches the kernel once for each of the
    static forward's 64 BatchNorms, counted in ``bn_act``; a forward with
    gradients on launches none."""
    from retargetvid_tpu_torch import bench
    from retargetvid_tpu_torch.config import sc_init_crop_params
    from retargetvid_tpu_torch.kernels.build import LAUNCHES
    from retargetvid_tpu_torch.ops.boxes import calc_dest_size
    from retargetvid_tpu_torch.pipeline.oneshot import (
        OneShotClipProgram,
        StageTimer,
    )

    cp = sc_init_crop_params()
    cp['out_ratio'] = '1:3'
    dest = calc_dest_size(640, 360, '1:3')
    tn, un = bench.build_models()
    with torch.no_grad():           # sampling's every-skip regime, as bench.py
        tn.dense2.bias.copy_(torch.tensor(bench.HEAD_BIAS))
    program = OneShotClipProgram(tn, un, tn_fullseq=True)
    program.timer = StageTimer()
    for seed in (0, 1):
        clip = torch.from_numpy(bench.make_clip(seed=seed)).to(cuda_device)
        launches = LAUNCHES['bn_act']
        program.collect(program.dispatch(
            clip, cp, fps=30.0, w_final=dest['w_final'],
            h_final=dest['h_final']))
        assert LAUNCHES['bn_act'] == launches + 64
    assert program.timer.counts()['bn_act'] == [64, 64]
    launches = LAUNCHES['bn_act']
    with torch.enable_grad():
        un(torch.rand((2, 1, 256, 416, 3), device=cuda_device),
           source='SALICON')
    assert LAUNCHES['bn_act'] == launches
