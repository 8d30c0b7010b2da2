"""Dynamic saliency: the port's ``smooth_sequence`` and
``SaliencyPredictor.predict_video`` vs the JAX package's.

``smooth_sequence`` must equal numpy's median exactly, even-sized windows
at the ends of the clip included.  ``predict_video`` runs at
``TINY_UNISAL_CFG`` (RNN weights drawn from a seed, carried across) on a
9-frame 64x64 clip, ``frame_modulo`` 3, ``seq_len`` 2 and 9, with and
without ``med3``: uint8 maps within 1 LSB, the count of differing pixels
pinned.  The JAX tail (``pipeline/saliency.py:180-183``) is numpy's
float32 ``exp``; the port's is the postprocess kernel (its plain version,
``torch.exp``, on the CPU): their difference on the same
log-probabilities is counted separately.  The ``cuda`` case holds the
kernel tail against the plain version on the card.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

T, H, W = 9, 64, 64
#: Pixels of the 9x64x64 maps 1 LSB apart from JAX's, per
#: (seq_len, smoothing); no pixel differs by more.  The smoother is exact
#: (below); a pixel moves where the log-probabilities' float32 difference
#: (the Lanczos preprocess, ROADMAP Queue 3) or ``torch.exp`` against
#: numpy's ``exp`` (:func:`test_plain_tail_against_numpy_tail`) carries a
#: value across a quantization step.
PINNED_DIFF = {(2, None): 0, (9, None): 0, (2, 'med3'): 1, (9, 'med3'): 1}


def clip(t=T, h=H, w=W, seed=0):
    """A blob moving over seeded noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = rng.integers(0, 60, (h, w, 3))
    frames = np.empty((t, h, w, 3), np.uint8)
    for i in range(t):
        cx, cy = w * (0.2 + 0.6 * i / t), h * (0.5 + 0.2 * np.sin(i))
        blob = 200 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 80.0)
        frames[i] = np.clip(base + blob[..., None], 0, 255)
    return frames


def smooth_log_maps(t, h, w, seed=11):
    """Log-probabilities of smooth saliency-like maps: per frame, a sum of
    5 Gaussian blobs over a floor, normalized (float32), so the maps span
    the whole uint8 range as UNISAL's do."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = np.empty((t, h, w), np.float32)
    for i in range(t):
        field = np.full((h, w), 1e-3)
        for cy, cx, s in zip(rng.uniform(0, h, 5), rng.uniform(0, w, 5),
                             rng.uniform(10, 80, 5)):
            field += np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))
        out[i] = np.log(field / field.sum())
    return out


SMOOTH_CASES = [
    ((50, 6, 7), 'med41'),          # interior windows and even-sized ends
    ((1, 50, 1, 6, 7), 'med41'),    # the reference's 5-D layout
    ((12, 4, 5), 'med4'),           # windows of 5, ends of 3 and 4
    ((1, 12, 1, 4, 5), 'med4'),
    ((10, 3, 3), 'med41'),          # shorter than a window: all ends
    ((9, 4, 5), 'med3'),
]


@pytest.mark.parametrize('shape,method', SMOOTH_CASES,
                         ids=[f'{m}-{"x".join(map(str, s))}'
                              for s, m in SMOOTH_CASES])
def test_smooth_sequence_equals_numpy(shape, method, monkeypatch):
    from retargetvid_tpu.utils.sequence import smooth_sequence as jsmooth
    from retargetvid_tpu_torch.utils import sequence

    seq = np.random.default_rng(len(shape)).normal(
        -9, 2, shape).astype(np.float32)
    # Few interior frames per sort block, so the blocks are exercised.
    monkeypatch.setattr(sequence, '_BLOCK_ELEMS', 3 * seq[0].size * 41)
    ref = jsmooth(seq.copy(), method)
    out = sequence.smooth_sequence(torch.from_numpy(seq), method).numpy()
    assert out.dtype == ref.dtype and out.shape == ref.shape
    np.testing.assert_array_equal(out, ref)


def numpy_tail(p):
    """The JAX package's ``predict_video`` tail from ``p = exp(logp)``."""
    mx = p.max(axis=(1, 2), keepdims=True)
    return (np.where(mx > 0, p / mx, p) * 255.0).astype(np.uint8)


def test_plain_tail_against_numpy_tail():
    """The plain postprocess against the JAX tail on the same smooth
    log-probabilities: ``torch.exp`` and numpy's float32 ``exp`` differ by
    an ulp in 39% of the values, which moves the pixels pinned here across
    a quantization step (1 LSB); numpy's tail from ``torch.exp`` gives the
    plain version's maps exactly."""
    from retargetvid_tpu_torch.kernels.postprocess import (
        saliency_postprocess_reference,
    )
    logp = smooth_log_maps(24, 180, 320)
    x = torch.from_numpy(logp)
    out = saliency_postprocess_reference(x).numpy()
    diff = np.abs(out.astype(int) - numpy_tail(np.exp(logp)).astype(int))
    print(f'plain vs numpy tail: {int((diff > 0).sum())} of {diff.size} '
          f'pixels differ, max {int(diff.max())} LSB')
    assert diff.max() <= 1 and int((diff > 0).sum()) == 5
    np.testing.assert_array_equal(numpy_tail(torch.exp(x).numpy()), out)


@pytest.fixture(scope='module')
def predictors():
    from conftest import TINY_UNISAL_CFG
    from retargetvid_tpu.models.unisal import UNISAL as JUNISAL
    from retargetvid_tpu.pipeline.saliency import SaliencyPredictor as JSal
    from retargetvid_tpu_torch.convert import load_flax_variables
    from retargetvid_tpu_torch.models.unisal import UNISAL
    from retargetvid_tpu_torch.pipeline.saliency import SaliencyPredictor
    from test_torch_unisal_dynamic import tiny_variables

    variables = tiny_variables()
    return (JSal(variables=variables, model=JUNISAL(**TINY_UNISAL_CFG)),
            SaliencyPredictor(load_flax_variables(
                UNISAL(**TINY_UNISAL_CFG), variables), device='cpu'))


@pytest.mark.parametrize('seq_len,smooth', list(PINNED_DIFF),
                         ids=[f'seq{s}-{m}' for s, m in PINNED_DIFF])
def test_predict_video_matches_jax(predictors, seq_len, smooth):
    jsal, sal = predictors
    frames = clip()
    kw = dict(source='DHF1K', frame_modulo=3, seq_len=seq_len,
              smooth_method=smooth)
    ref = jsal.predict_video(frames, **kw)
    out = sal.predict_video(frames, **kw)
    assert out.shape == ref.shape == (T, H, W) and out.dtype == np.uint8
    diff = np.abs(out.astype(int) - ref.astype(int))
    n_diff = int((diff > 0).sum())
    print(f'predict_video seq_len={seq_len} smooth={smooth}: {n_diff} of '
          f'{diff.size} pixels differ, max {int(diff.max())} LSB')
    assert diff.max() <= 1
    assert n_diff == PINNED_DIFF[(seq_len, smooth)]


def test_predict_video_carries_the_hidden_state(predictors):
    """A clip in chunks of 2 frames per offset against one chunk of 9:
    equal within 1 LSB, and different from chunks that restart at zero."""
    _, sal = predictors
    frames = clip(seed=1)
    kw = dict(frame_modulo=1, smooth_method=None)
    short = sal.predict_video(frames, seq_len=2, **kw)
    whole = sal.predict_video(frames, seq_len=9, **kw)
    assert np.abs(short.astype(int) - whole.astype(int)).max() <= 1
    restarted = np.concatenate([
        sal.predict_video(frames[s:s + 2], seq_len=2, **kw)
        for s in range(0, T, 2)])
    assert np.abs(restarted.astype(int) - whole.astype(int)).max() > 1


@pytest.mark.cuda
def test_predict_video_kernel_tail_on_the_card(monkeypatch):
    """On the card ``predict_video`` launches the postprocess kernel once
    for the whole stack and gives the maps of the plain version swapped
    in."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA GPU (run on the card: python -m pytest '
                    'tests/test_torch_predict_video.py -m cuda '
                    '--noconftest)')
    from retargetvid_tpu_torch.kernels.build import LAUNCHES
    from retargetvid_tpu_torch.kernels.postprocess import (
        saliency_postprocess_reference,
    )
    from retargetvid_tpu_torch.models.init import seeded_init_
    from retargetvid_tpu_torch.models.unisal import UNISAL
    from retargetvid_tpu_torch.pipeline import saliency

    tiny = dict(cnn_widen_factor=0.25, cnn_last_channel=None,
                rnn_input_channels=32, rnn_hidden_channels=32,
                smoothing_ksize=11, smoothing_rank=4)
    sal = saliency.SaliencyPredictor(seeded_init_(UNISAL(**tiny), 1))
    frames = clip(t=37, h=90, w=160)
    for smooth in (None, 'med41'):
        LAUNCHES.clear()
        maps = sal.predict_video(frames, smooth_method=smooth)
        assert LAUNCHES['saliency_postprocess'] == 1
        with monkeypatch.context() as m:
            m.setattr(saliency, 'saliency_postprocess',
                      saliency_postprocess_reference)
            plain = sal.predict_video(frames, smooth_method=smooth)
        assert LAUNCHES['saliency_postprocess'] == 1
        assert maps.shape == (37, 90, 160) and np.array_equal(maps, plain)


#: Pixels of :func:`test_kernel_tail_against_numpy_on_the_card`'s stack
#: where the kernel's map is 1 LSB from numpy's tail (on an H100).
PINNED_CARD_TAIL_DIFF = 72


@pytest.mark.cuda
def test_kernel_tail_against_numpy_on_the_card():
    """The kernel against the JAX package's numpy tail
    (``retargetvid_tpu/pipeline/saliency.py:180-183``) on the same seeded
    (96, 360, 640) log-probabilities: 1 LSB at most, in the pixels pinned
    here, and every one of them explained by the card's ``exp``: numpy's
    tail computed from the card's ``exp`` gives the kernel's maps."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA GPU (run on the card: python -m pytest '
                    'tests/test_torch_predict_video.py -m cuda '
                    '--noconftest)')
    from retargetvid_tpu_torch.kernels.postprocess import saliency_postprocess

    logp = smooth_log_maps(96, 360, 640)
    x = torch.from_numpy(logp).cuda()
    maps = saliency_postprocess(x).cpu().numpy()
    diff = np.abs(maps.astype(int) - numpy_tail(np.exp(logp)).astype(int))
    n_diff = int((diff > 0).sum())
    print(f'kernel vs numpy tail: {n_diff} of {diff.size} pixels differ, '
          f'max {int(diff.max())} LSB')
    assert diff.max() <= 1
    np.testing.assert_array_equal(numpy_tail(torch.exp(x).cpu().numpy()),
                                  maps)
    assert n_diff == PINNED_CARD_TAIL_DIFF
