"""The port's host shot-scoring modules (``models/transnet_post.py``,
``models/shot_scoring.py``) vs the JAX package's, on seeded signals.
Both are numpy/scipy, so every result must be equal."""

import numpy as np
import pytest

SIZES = (30, 80, 200)


def signal(n, seed=4):
    """Transition probabilities: a noisy sine with four sharp spikes."""
    rng = np.random.default_rng(seed + n)
    sig = 0.3 + 0.3 * np.sin(np.linspace(0, 6 * np.pi, n)) \
        + 0.15 * rng.random(n)
    sig[np.linspace(5, n - 6, 4).astype(int)] += 0.5
    return np.clip(sig, 0, 1)


def _equal(a, b):
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        assert type(a) is type(b)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


SHOT_SCORING = [
    ('mov_avg', dict(window=5)),
    ('smooth', dict(window=3)),
    ('find_extremas', dict(order=3)),
    ('process_sd_x', dict(window=3, order=3)),
]


@pytest.mark.parametrize('n', SIZES)
@pytest.mark.parametrize('name,kw', SHOT_SCORING,
                         ids=[c[0] for c in SHOT_SCORING])
def test_shot_scoring_signals(name, kw, n):
    from retargetvid_tpu.models import shot_scoring as jss
    from retargetvid_tpu_torch.models import shot_scoring as ss

    x = signal(n)
    _equal(getattr(ss, name)(x, **kw), getattr(jss, name)(x, **kw))


@pytest.mark.parametrize('t', [0.2, 0.4])
def test_shot_scoring_boundaries(t):
    from retargetvid_tpu.models import shot_scoring as jss
    from retargetvid_tpu_torch.models import shot_scoring as ss

    y = ss.process_sd_x(signal(200))[0]
    assert ss.trans_to_boundaries(y, t) == jss.trans_to_boundaries(y, t)
    assert ss.trans_to_list(y, t) == jss.trans_to_list(y, t)
    assert len(ss.trans_to_list(y, t)) > 1


@pytest.mark.parametrize('n', SIZES)
def test_transnet_post_scenes(n):
    from retargetvid_tpu.models import transnet_post as jtp
    from retargetvid_tpu_torch.models import transnet_post as tp

    p = signal(n, seed=9)
    _equal(tp.smooth_predictions(p), jtp.smooth_predictions(p))
    for th in (0.5, 0.7):
        _equal(tp.scenes_from_predictions(p, th),
               jtp.scenes_from_predictions(p, th))
        shots = tp.shots_from_predictions(p, th, min_shot_len=6)
        _equal(shots, jtp.shots_from_predictions(p, th, min_shot_len=6))
        tp.assert_segmentation(shots, n, min_shot_len=6)
    with pytest.raises(AssertionError):
        tp.assert_segmentation(np.array([[1, n - 1]]), n)


def test_transnet_post_debug_grid():
    from retargetvid_tpu.models import transnet_post as jtp
    from retargetvid_tpu_torch.models import transnet_post as tp

    rng = np.random.default_rng(2)
    frames = rng.integers(0, 255, (23, 12, 16, 3)).astype(np.uint8)
    p = rng.random(23).astype(np.float32)
    grid = tp.draw_video_with_predictions(frames, p, width=5)
    assert grid.shape == (5 * 12, 5 * 16, 3)
    _equal(grid, jtp.draw_video_with_predictions(frames, p, width=5))
