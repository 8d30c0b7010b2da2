"""Port vs JAX: the TransNet clip plans (eager windows, the windowed and
full-sequence predictor, the ingest+shot program) and the host-side
sampling rule and scene tables of the two-dispatch path.

TransNet is narrow (``f=2``; ``d=16``, ``d=8`` for the ingest program, as
the JAX package's own tests) and float32; the port's weights are the JAX
ones carried across by ``convert``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_resize import _tap_sums

torch.set_num_threads(1)


def _transnet_pair(d=16, seed=0):
    from retargetvid_tpu.models.transnet import TransNetV1 as JTransNet
    from retargetvid_tpu_torch.convert import load_flax_variables
    from retargetvid_tpu_torch.models.transnet import TransNetV1

    jt = JTransNet(f=2, d=d)
    params = jax.tree_util.tree_map(np.asarray, jt.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8, 27, 48, 3), jnp.uint8)))
    return jt, params, load_flax_variables(TransNetV1(f=2, d=d), params)


@pytest.fixture(scope='module')
def transnet():
    return _transnet_pair()


def _frames(n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 255, (n, 27, 48, 3)).astype(np.uint8)


@pytest.mark.parametrize('n', [37, 100, 173])
def test_predict_video_windows(transnet, n):
    """The eager window plan: probabilities within 1e-5."""
    from retargetvid_tpu.models.transnet import (
        predict_video_windows as j_windows,
    )
    from retargetvid_tpu_torch.models.transnet import predict_video_windows

    jt, params, tn = transnet
    frames = _frames(n, seed=n)
    ref = j_windows(jax.jit(lambda b: jt.apply(params, b)), frames)
    with torch.no_grad():
        out = predict_video_windows(tn, frames)
    print(f'n={n}: max |diff| {np.abs(out - ref).max():.3g} (atol 1e-5)')
    assert out.shape == ref.shape == (n,)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize('n', [37, 100, 173])
def test_transnet_predictor_windowed(transnet, n):
    """The one-batch window plan, N padded to a multiple of 64 (for n=173:
    6 windows where the one-shot body's fc=173 gives 4): within 1e-5 of
    JAX and of the port's eager plan."""
    from retargetvid_tpu.models.transnet import (
        TransNetPredictor as JPredictor,
    )
    from retargetvid_tpu_torch.models.transnet import (
        TransNetPredictor,
        predict_video_windows,
        window_forward,
    )

    jt, params, tn = transnet
    frames = _frames(n, seed=n)
    ref = JPredictor(jt, params)(frames)
    out = TransNetPredictor(tn, device='cpu')(frames)
    assert out.shape == ref.shape == (n,)
    print(f'n={n}: max |diff| {np.abs(out - ref).max():.3g} (atol 1e-5)')
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    with torch.no_grad():
        np.testing.assert_allclose(out, predict_video_windows(tn, frames),
                                   rtol=0, atol=1e-5)
        # The one-shot body's window count (cap = n): the first n agree.
        own = window_forward(tn, torch.from_numpy(frames), n, n).numpy()
    np.testing.assert_allclose(own, out, rtol=0, atol=1e-5)


def test_fullseq_equals_clipwide_window(transnet):
    """One forward over the edge-padded clip == one window spanning the
    clip (the convs zero-pad at the window's edges exactly as at the
    sequence's), and == JAX's full-sequence predictor."""
    from retargetvid_tpu.models.transnet import (
        TransNetPredictor as JPredictor,
    )
    from retargetvid_tpu_torch.models.transnet import TransNetPredictor

    jt, params, tn = transnet
    n = 64
    frames = _frames(n, seed=3)
    full = TransNetPredictor(tn, fullseq=True, device='cpu')(frames)
    wide = TransNetPredictor(tn, window=n + 50, stride=n + 50,
                             keep=(25, n + 25), device='cpu')(frames)
    print(f'fullseq vs clip-wide window: max |diff| '
          f'{np.abs(full - wide).max():.3g} (atol 1e-5)')
    np.testing.assert_allclose(full, wide, rtol=0, atol=1e-5)
    ref = JPredictor(jt, params, fullseq=True)(frames)
    np.testing.assert_allclose(full, ref, rtol=0, atol=1e-5)


def test_ingest_shot_program():
    """Resizes + window plan: probs within 1e-5; the saliency frames equal
    the port's rounding form exactly and JAX's except where XLA:CPU's
    fused multiply-add and the port's separately rounded products fall on
    either side of a .5 boundary (see ``test_torch_resize.py``)."""
    from retargetvid_tpu.models.transnet import (
        IngestShotProgram as JIngest,
    )
    from retargetvid_tpu.ops.resize import _resize_matrix_np
    from retargetvid_tpu_torch.models.transnet import IngestShotProgram

    jt, params, tn = _transnet_pair(d=8)
    rng = np.random.default_rng(0)
    h, w, n = 90, 160, 73
    frames = rng.integers(0, 255, (n, h, w, 3)).astype(np.uint8)
    j_sal, j_probs = JIngest(jt, params, sal_hw=(36, 64))(frames)
    sal, probs = IngestShotProgram(tn, sal_hw=(36, 64), device='cpu')(frames)
    print(f'probs: max |diff| {np.abs(probs - j_probs).max():.3g} '
          f'(atol 1e-5)')
    np.testing.assert_allclose(probs, j_probs, rtol=0, atol=1e-5)

    def u8(v):
        return np.clip(np.floor(v + np.float32(0.5)), 0, 255).astype(
            np.uint8)

    rows = _tap_sums(frames, 1, _resize_matrix_np(h, 36, 'linear'),
                     fused=False)
    a_w = _resize_matrix_np(w, 64, 'linear')
    unfused = u8(_tap_sums(rows, 2, a_w, fused=False))
    fused_w = u8(_tap_sums(rows, 2, a_w, fused=True))
    sal, j_sal = sal.numpy(), np.asarray(j_sal)
    assert sal.shape == j_sal.shape == (n, 36, 64, 3)
    assert (sal == unfused).all()
    straddle = unfused != fused_w
    differ = sal != j_sal
    print(f'sal frames: {int(differ.sum())} of {sal.size} uint8 values '
          f'differ, {int(straddle.sum())} straddle a .5 boundary')
    assert not (differ & ~straddle).any()
    assert int(np.abs(sal.astype(int) - j_sal.astype(int)).max()) <= 1


def _profiles():
    rng = np.random.default_rng(5)
    cases = [((rng.random(int(rng.integers(10, 260))) < 0.06) * 0.9)
             .astype(np.float32) for _ in range(8)]
    cases.append(np.full(40, 0.9, np.float32))      # every frame a cut
    cases.append(np.zeros(40, np.float32))          # no cut
    last = np.zeros(50, np.float32)
    last[-1] = 0.9                                  # cut on the last frame
    cases.append(last)
    first = np.zeros(60, np.float32)
    first[0] = 0.9                                  # cut on the first frame
    cases.append(first)
    return cases


@pytest.mark.parametrize('case', range(len(_profiles())))
def test_sampling_and_scene_tables_exact(case):
    """``sample_frames``, ``predictions_to_scenes``, ``fix_scene_bounds``,
    ``scenes_to_selected`` and ``insert_cuts`` equal JAX's exactly."""
    from retargetvid_tpu.ops import scenes as j_scenes
    from retargetvid_tpu.pipeline.ingest import (
        sample_frames as j_sample_frames,
    )
    from retargetvid_tpu_torch.ops import scenes
    from retargetvid_tpu_torch.pipeline.ingest import (
        TRANS_THRESHOLD,
        sample_frames,
    )

    probs = _profiles()[case]
    fc = len(probs)
    skip = (6, 4, 1, 9)[case % 4]
    ref = j_sample_frames(fc, probs, skip, fc)
    out = sample_frames(fc, probs, skip, fc)
    assert out == ref
    _, true_inds, m2o = out

    raw = scenes.predictions_to_scenes(probs, TRANS_THRESHOLD)
    assert np.array_equal(raw, j_scenes.predictions_to_scenes(
        probs, TRANS_THRESHOLD))
    seg = scenes.fix_scene_bounds(raw, fc)
    assert np.array_equal(seg, j_scenes.fix_scene_bounds(raw, fc))
    seg_sel = scenes.scenes_to_selected(seg, m2o)
    ref_sel = j_scenes.scenes_to_selected(seg, m2o)
    assert seg_sel.dtype == ref_sel.dtype and np.array_equal(seg_sel, ref_sel)

    rng = np.random.default_rng(case)
    n_extra = int(rng.integers(0, 14))
    at = rng.integers(0, len(true_inds), n_extra).tolist()
    scores = rng.uniform(0, 255, n_extra).tolist()
    got = scenes.insert_cuts(seg, seg_sel, true_inds, at, scores)
    want = j_scenes.insert_cuts(seg, seg_sel, true_inds, at, scores)
    for a, b in zip(got, want):
        assert np.array_equal(np.asarray(a), np.asarray(b))
