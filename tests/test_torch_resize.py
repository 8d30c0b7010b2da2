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


def test_saliency_ingest_resize(clip):
    """360x640 -> 140x250.  The port sums each output's two products in a
    fixed order with every product rounded (what XLA:CPU does for the 27x48
    shape); for this shape XLA fuses the second multiply-add, which moves
    about 0.03% of the values across a .5 boundary.  Held to 1 LSB there
    and exact everywhere else."""
    ref = _jax_ingest(clip, (140, 250))
    out = _port_ingest(clip, (140, 250))
    assert out.shape == ref.shape == (12, 140, 250, 3)
    diff = np.abs(out.astype(int) - ref.astype(int))
    share = float((diff > 0).mean())
    print(f'140x250: max |diff| {diff.max()} LSB (tolerance 1), '
          f'{share:.4%} of values differ (tolerance 0.1%)')
    assert diff.max() <= 1
    assert share < 1e-3


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
    they differ by exactly one uint8 step."""
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
