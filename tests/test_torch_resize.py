"""Port vs JAX: the ingest resizes and the saliency preprocess."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)


def _bench_clip(n_frames, seed):
    spec = importlib.util.spec_from_file_location(
        'bench', Path(__file__).resolve().parent.parent / 'bench.py')
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    return bench.make_clip(n_frames, 360, 640, seed=seed)


@pytest.fixture(scope='module')
def clip():
    return _bench_clip(12, seed=3)


def _jax_ingest(frames, hw):
    from retargetvid_tpu.ops.resize import resize, round_half_up
    fn = jax.jit(lambda x: jnp.clip(round_half_up(resize(x, hw, 'linear')),
                                    0, 255).astype(jnp.uint8))
    return np.asarray(fn(jnp.asarray(frames)))


def _port_ingest(frames, hw):
    from retargetvid_tpu_torch.ops.resize import resize, round_half_up
    x = resize(torch.from_numpy(frames), hw, 'linear', channels_last=True)
    return torch.clamp(round_half_up(x), 0, 255).to(torch.uint8).numpy()


def test_round_half_up_is_not_half_even():
    from retargetvid_tpu_torch.ops.resize import round_half_up
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, 2.4999])
    assert round_half_up(x).tolist() == [1.0, 2.0, 3.0, 0.0, 2.0]


def test_transnet_ingest_resize_exact(clip):
    """360x640 -> 27x48: exactly the JAX uint8 output."""
    ref = _jax_ingest(clip, (27, 48))
    out = _port_ingest(clip, (27, 48))
    assert out.shape == ref.shape == (12, 27, 48, 3)
    n_diff = int((out != ref).sum())
    print(f'27x48: {n_diff} of {ref.size} uint8 values differ (tolerance 0)')
    assert n_diff == 0


def _tap_sums(x, axis, a, fused):
    """One axis of the interpolation matrix ``a`` (dst, src) applied in
    numpy as a sum over each row's nonzero taps, ascending: the first
    product rounded to float32, then each further tap added either as a
    separately rounded product (``fused=False``: the port's form) or as one
    fused multiply-add, rounded once (``fused=True``); float64 holds the
    exact product and sum before the rounding."""
    nz = [np.nonzero(row)[0] for row in a]
    k = max(len(n) for n in nz)
    idx = np.zeros((k, a.shape[0]), np.int64)
    w = np.zeros((k, a.shape[0]), np.float32)
    for d, n in enumerate(nz):
        idx[:len(n), d] = n
        w[:len(n), d] = a[d, n]
    x = np.moveaxis(x.astype(np.float32), axis, -1)
    acc = x[..., idx[0]] * w[0]
    for j in range(1, k):
        xj = x[..., idx[j]]
        if fused:
            acc = (xj.astype(np.float64) * w[j] + acc).astype(np.float32)
        else:
            acc = acc + xj * w[j]
    return np.moveaxis(acc, -1, axis)


def test_saliency_ingest_resize(clip):
    """360x640 -> 140x250, pinned to its cause.  XLA:CPU computes the
    height product of this shape with every product rounded (the port's
    form, and its form for both products of 27x48), but the width product
    as ``fma(x1, w1, round(x0 * w0))``.  So JAX equals that emulation bit
    for bit in float32, the port equals the unfused form, and their uint8
    values differ exactly where the two forms fall on either side of a .5
    boundary (408 values of this clip, 0.03%)."""
    from retargetvid_tpu.ops.resize import _resize_matrix_np
    from retargetvid_tpu.ops.resize import resize as jresize
    from retargetvid_tpu_torch.ops.resize import resize as port_resize
    hw = (140, 250)
    a_h = _resize_matrix_np(360, hw[0], 'linear')
    a_w = _resize_matrix_np(640, hw[1], 'linear')
    rows = _tap_sums(clip, 1, a_h, fused=False)
    unfused = _tap_sums(rows, 2, a_w, fused=False)
    fused_w = _tap_sums(rows, 2, a_w, fused=True)

    jax_f32 = np.asarray(jax.jit(lambda x: jresize(x, hw, 'linear'))(
        jnp.asarray(clip)))
    assert int((jax_f32 != fused_w).sum()) == 0
    port_f32 = port_resize(torch.from_numpy(clip), hw, 'linear',
                           channels_last=True).numpy()
    assert int((port_f32 != unfused).sum()) == 0

    def u8(v):
        return np.clip(np.floor(v + np.float32(0.5)), 0, 255).astype(np.uint8)

    ref = _jax_ingest(clip, hw)
    out = _port_ingest(clip, hw)
    assert out.shape == ref.shape == (12, 140, 250, 3)
    assert (ref == u8(fused_w)).all() and (out == u8(unfused)).all()
    straddle = u8(unfused) != u8(fused_w)
    print(f'140x250: {int((out != ref).sum())} of {ref.size} uint8 values '
          f'differ, all of them where the forms straddle a .5 boundary '
          f'({int(straddle.sum())})')
    assert ((out != ref) == straddle).all()
    assert int(np.abs(out.astype(int) - ref.astype(int)).max()) <= 1


def test_resize_matches_jax_matrix_form():
    """Every method and both layouts against the JAX matrix product, in
    float32, on random data (rounding-order differences only)."""
    from retargetvid_tpu.ops.resize import resize as jresize
    from retargetvid_tpu.ops.resize import resize_by_factor as jbyfac
    from retargetvid_tpu_torch.ops.resize import resize, resize_by_factor

    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (2, 37, 53, 3)).astype(np.float32)
    maps = rng.uniform(0, 255, (3, 37, 53)).astype(np.float32)
    for method, hw in (('linear', (20, 70)), ('nearest', (74, 26)),
                       ('cubic', (19, 31)), ('lanczos', (64, 96))):
        ref = np.asarray(jresize(jnp.asarray(img), hw, method))
        out = resize(torch.from_numpy(img), hw, method,
                     channels_last=True).numpy()
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-3,
                                   err_msg=method)
        ref = np.asarray(jresize(jnp.asarray(maps), hw, method,
                                 channels_last=False))
        out = resize(torch.from_numpy(maps), hw, method,
                     channels_last=False).numpy()
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-3,
                                   err_msg=method)
    ref = np.asarray(jbyfac(jnp.asarray(maps), 4.0, 'linear',
                            channels_last=False))
    out = resize_by_factor(torch.from_numpy(maps), 4.0, 'linear',
                           channels_last=False).numpy()
    assert out.shape == ref.shape == (3, 9, 13)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-3)


def test_preprocess_frames(clip):
    """Lanczos to 224x416, round-half-up, /255, ImageNet norm.  Values agree
    to 1e-6 except where the Lanczos sum lands on the other side of a .5
    uint8 boundary (a rounding-order effect, under 0.01% of values), where
    they differ by exactly one uint8 step.  The 140x250 ingest's
    explanation does not carry over: no per-axis form of the 6-tap sums
    (every product rounded, a chain of fused multiply-adds, blocked or
    4/8/16-lane partial sums) reproduces XLA:CPU's float32 values here, so
    the tolerance stays."""
    from retargetvid_tpu.pipeline.saliency import preprocess_frames as jpre
    from retargetvid_tpu_torch.pipeline.saliency import preprocess_frames

    sal = _jax_ingest(clip, (140, 250))
    ref = np.asarray(jax.jit(lambda x: jpre(x, (224, 416)))(
        jnp.asarray(sal)))
    out = preprocess_frames(torch.from_numpy(sal.copy()), (224, 416)).numpy()
    assert out.shape == ref.shape == (12, 224, 416, 3)
    diff = np.abs(out - ref)
    off = diff > 1e-6
    step = (1.0 / 255.0) / np.asarray([0.229, 0.224, 0.225], np.float32)
    print(f'preprocess: {off.mean():.5%} of values beyond 1e-6 '
          f'(tolerance 0.01%), max |diff| {diff.max():.3g}')
    assert off.mean() < 1e-4
    steps = np.broadcast_to(step, diff.shape)[off]
    np.testing.assert_allclose(diff[off], steps, rtol=1e-3)
