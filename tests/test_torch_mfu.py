"""The MFU tool's FLOP counts (``retargetvid_tpu_torch/mfu.py``).

- The analytic count (conv and dense layers' shapes, on the ``meta``
  device) equals ``FlopCounterMode``'s total exactly for the narrow and the
  full-width UNISAL over 4 frames of 224x416 and full-width TransNet over
  100 frames, and at the tool's two bench targets.
- Against XLA's ``cost_analysis()['flops']`` of the JAX forward at the same
  shapes (UNISAL to a 140x250 target, the bench's) the ratio is printed and
  lies in [0.8, 1.2].
- TransNet's surplus over XLA is the counting convention: XLA counts only
  the kernel taps that land inside the input, so its count is the valid-tap
  count (of JAX's folded form, each temporal tap a conv over every frame)
  plus the elementwise work, while the port's count, like the counter's,
  counts every tap of a zero-padded border.
- The bench clip's model FLOPs follow its plans' frame counts.

The ``cuda`` case measures both targets on the card: ``python -m pytest
tests/test_torch_mfu.py -m cuda --noconftest``.
"""

import math

import pytest
import torch

torch.set_num_threads(1)

X_UNISAL = ((4, 1, 224, 416, 3), torch.float32)
X_TRANSNET = ((1, 100, 27, 48, 3), torch.uint8)


def _unisal_fwd(model, x):
    return model(x, target_size=(140, 250), source='SALICON')


def _transnet_fwd(model, x):
    return model(x)


def _model(name):
    from retargetvid_tpu_torch.dryrun import TINY_UNISAL
    from retargetvid_tpu_torch.models.transnet import TransNetV1
    from retargetvid_tpu_torch.models.unisal import UNISAL

    return {'unisal_tiny': lambda: UNISAL(**TINY_UNISAL),
            'unisal': UNISAL, 'transnet': TransNetV1}[name]()


def _case(name):
    from retargetvid_tpu_torch import mfu

    if name == 'unisal_target':
        t = mfu.unisal_target(_model('unisal'))
        return t['model'], t['count_fn'], t['input']
    if name == 'transnet_target':
        t = mfu.transnet_target(_model('transnet'))
        return t['model'], t['count_fn'], t['input']
    if name.startswith('unisal'):
        return _model(name), _unisal_fwd, X_UNISAL
    return _model(name), _transnet_fwd, X_TRANSNET


@pytest.mark.parametrize('name', ('unisal_tiny', 'unisal', 'transnet',
                                  'unisal_target', 'transnet_target'))
def test_layer_count_equals_flop_counter(name):
    from retargetvid_tpu_torch.mfu import counter_flops, layer_flops

    model, fn, x = _case(name)
    flops = layer_flops(fn, model, x)
    print(f'{name}: {flops / 1e9} GFLOP')
    assert flops > 0
    assert flops == counter_flops(fn, model, x)


def _xla_flops(name):
    import jax
    import jax.numpy as jnp

    from conftest import TINY_UNISAL_CFG
    from retargetvid_tpu.models.transnet import TransNetV1
    from retargetvid_tpu.models.unisal import UNISAL

    if name.startswith('unisal'):
        model = UNISAL(**(TINY_UNISAL_CFG if name == 'unisal_tiny' else {}))
        x = jax.ShapeDtypeStruct(X_UNISAL[0], jnp.float32)
        init_kw = dict(static=True)
        apply_kw = dict(static=True, target_size=(140, 250),
                        source='SALICON')
    else:
        model = TransNetV1()
        x = jax.ShapeDtypeStruct(X_TRANSNET[0], jnp.uint8)
        init_kw = apply_kw = {}
    variables = jax.eval_shape(lambda k, v: model.init(k, v, **init_kw),
                               jax.random.PRNGKey(0), x)
    cost = jax.jit(lambda v, a: model.apply(v, a, **apply_kw)).lower(
        variables, x).compile().cost_analysis()
    if isinstance(cost, (list, tuple)):
        cost = cost[0]
    return float(cost['flops'])


@pytest.mark.parametrize('name', ('unisal_tiny', 'unisal', 'transnet'))
def test_ratio_to_xla_cost_analysis(name):
    from retargetvid_tpu_torch.mfu import layer_flops

    model, fn, x = _case(name)
    port, xla = layer_flops(fn, model, x), _xla_flops(name)
    print(f'{name}: port {port / 1e9} GFLOP, XLA {xla / 1e9} GFLOP, ratio '
          f'{port / xla}')
    assert 0.8 <= port / xla <= 1.2


def _transnet_taps(t=100, h=27, w=48, f=16, l=3, s=2, d=256, valid=False):
    """TransNetV1's conv and dense FLOPs over t frames: every 3x3x3 tap, or
    with ``valid`` only the spatial taps inside the frame (each of the 3
    temporal taps over all t frames, JAX's folded form)."""
    def taps(n):
        return sum(sum(0 <= o - 1 + j < n for j in range(3))
                   for o in range(n)) if valid else 3 * n

    total, c_in = 0, 3
    for idx_l in range(l):
        filters = 2 ** idx_l * f
        for _ in range(s):
            total += 4 * 2 * t * filters * c_in * 3 * taps(h) * taps(w)
            c_in = 4 * filters
        h, w = h // 2, w // 2
    return total + 2 * t * (h * w * c_in * d + d * 2)


def test_transnet_surplus_is_the_counting_convention():
    from retargetvid_tpu_torch.mfu import layer_flops

    model, fn, x = _case('transnet')
    port, xla = layer_flops(fn, model, x), _xla_flops('transnet')
    assert port == _transnet_taps()
    valid = _transnet_taps(valid=True)
    print(f'every tap {port / 1e9}, valid taps {valid / 1e9}, XLA '
          f'{xla / 1e9} GFLOP')
    # XLA's count is the valid taps plus a little elementwise work.
    assert valid < xla < 1.005 * valid


def test_bench_clip_flops():
    from retargetvid_tpu_torch import mfu

    un, tn = _model('unisal'), _model('transnet')
    clip = mfu.clip_flops(un, tn)
    target = mfu.unisal_target(un)
    assert clip['unisal_flops'] == mfu.layer_flops(
        target['count_fn'], un, target['input'])
    for plan, frames in (('fullseq', (1, 530)), ('windowed', (11, 100))):
        assert clip[f'transnet_{plan}_flops'] == mfu.layer_flops(
            _transnet_fwd, tn, ((*frames, 27, 48, 3), torch.uint8)), plan
        assert clip[f'clip_{plan}_flops'] == \
            clip['unisal_flops'] + clip[f'transnet_{plan}_flops']
        ms = (clip['unisal_flops'] / mfu.PEAK_FLOPS[mfu.conv_dtype(
            torch.float32)] + clip[f'transnet_{plan}_flops'] /
            mfu.PEAK_FLOPS['bfloat16']) * 1e3
        assert math.isclose(clip[f'clip_{plan}_ms_at_peak'], ms)


def test_main_needs_a_gpu():
    from retargetvid_tpu_torch import mfu

    if torch.cuda.is_available():
        pytest.skip('a GPU is present: the no-GPU contract is moot')
    with pytest.raises(RuntimeError, match='CUDA'):
        mfu.main(['--reps', '1'])


@pytest.mark.cuda
def test_targets_on_the_card():
    """Both targets at full width on the card: the counted FLOPs equal the
    counter's on the card's own run, where the counter cannot see inside
    UNISAL's smoothing kernel and its two factors' FLOPs are added back;
    the slope is positive and the MFU a share of the peak."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA GPU (run on the card: python -m pytest '
                    'tests/test_torch_mfu.py -m cuda --noconftest)')
    from torch.utils.flop_counter import FlopCounterMode

    from retargetvid_tpu_torch import mfu
    from retargetvid_tpu_torch.bench import build_models
    from retargetvid_tpu_torch.kernels import smooth

    tn, un = build_models()
    kv = un.smoothing_v_salicon
    in_kernel = smooth.flops(mfu.PICKS, mfu.NET_HW, kv.shape[0], kv.shape[2])
    for target, hidden in ((mfu.unisal_target(un.cuda().eval()), in_kernel),
                           (mfu.transnet_target(tn.cuda()), 0)):
        row = mfu.measure(target, reps=2)
        shape, dtype = target['input']
        x = torch.randint(0, 255, shape, dtype=dtype, device='cuda')
        counter = FlopCounterMode(display=False)
        with counter, torch.inference_mode():
            target['count_fn'](target['model'], x)
        print(row)
        assert row['flops'] == row['counter_flops'] == \
            counter.get_total_flops() + hidden
        assert row['ms_per_forward'] > 0
        assert 0 < row['mfu'] < 1
