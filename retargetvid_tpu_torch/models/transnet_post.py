"""TransNet alternate post-processing (host numpy).

Port of ``retargetvid_tpu/models/transnet_post.py``: the reference's
second shot-detection post-processing path, which its pipeline does not
use (``transnetv1_handler.py:156-292``, ``transnet_utils.py:5-49``):
prediction smoothing, scenes from thresholded transition probabilities,
scene assembly with a minimum shot length, the debug scene-grid image and
the segmentation invariants.  No serving path imports it.
"""

from __future__ import annotations

import numpy as np

__all__ = ["smooth_predictions", "scenes_from_predictions",
           "shots_from_predictions", "assert_segmentation",
           "draw_video_with_predictions"]


def smooth_predictions(predictions: np.ndarray, window: int = 5) -> np.ndarray:
    """Box-smooth the per-frame transition probabilities."""
    p = np.asarray(predictions, np.float64)
    kernel = np.ones(window) / window
    return np.convolve(p, kernel, mode='same')


def scenes_from_predictions(predictions: np.ndarray,
                            threshold: float = 0.5) -> np.ndarray:
    """Contiguous [start, end] scene spans (transnet_utils variant: every
    frame belongs to exactly one scene; scenes split at each rising edge of
    the thresholded transition signal)."""
    preds = (np.asarray(predictions) > threshold).astype(np.uint8)
    splits = [0]
    for i in range(1, len(preds)):
        if preds[i] == 1 and preds[i - 1] == 0:
            splits.append(i)
    splits.append(len(preds))
    scenes = [[splits[k], splits[k + 1] - 1] for k in range(len(splits) - 1)]
    return np.array(scenes, dtype=np.int32)


def shots_from_predictions(predictions: np.ndarray, threshold: float = 0.5,
                           min_shot_len: int = 12) -> np.ndarray:
    """Scene list with short shots merged into their neighbors.

    Reference semantics (``transnetv1_handler.py:156-292``): transitions at
    smoothed local maxima above threshold; any resulting shot shorter than
    ``min_shot_len`` frames merges with the adjacent shot.
    """
    scenes = scenes_from_predictions(predictions, threshold)
    merged = []
    for s in scenes:
        if merged and (s[1] - s[0] + 1) < min_shot_len:
            merged[-1][1] = s[1]
        else:
            merged.append(list(s))
    # A short FIRST shot merges forward.
    if len(merged) >= 2 and (merged[0][1] - merged[0][0] + 1) < min_shot_len:
        merged[1][0] = merged[0][0]
        merged = merged[1:]
    return np.array(merged, dtype=np.int32)


def draw_video_with_predictions(frames: np.ndarray,
                                predictions: np.ndarray,
                                threshold: float = 0.1,
                                width: int = 20) -> np.ndarray:
    """Debug scene-grid image (reference ``transnet_utils.py:20-49``).

    Tiles the (down-scaled) frames into a grid ``width`` tiles wide and
    draws, on each tile's right edge, a vertical probability bar — green
    when the transition probability exceeds ``threshold``, red otherwise,
    length proportional to the probability and centered vertically — plus a
    black backing band and a white separator on each row's top edge.

    Host-side numpy (no PIL / device work); returns a (H, W, 3) uint8 image
    ready for ``cv2.imwrite``/``plt.imsave``.
    """
    frames = np.asarray(frames, np.uint8)
    predictions = np.asarray(predictions, np.float32)
    n, ih, iw, ic = frames.shape
    assert ic == 3 and len(predictions) == n
    if n % width:
        pad = width - n % width
        frames = np.concatenate(
            [frames, np.zeros((pad, ih, iw, ic), np.uint8)])
        predictions = np.concatenate(
            [predictions, np.zeros(pad, np.float32)])
        n += pad
    height = n // width

    grid = (frames.reshape(height, width, ih, iw, ic)
            .transpose(0, 2, 1, 3, 4)
            .reshape(height * ih, width * iw, ic).copy())

    for i, p in enumerate(predictions):
        h, w = divmod(i, width)
        y0, x0 = h * ih, w * iw
        # Black backing band at the tile's right edge (ref line width 4
        # centered on x = iw-3), then the probability bar (width 2).
        grid[y0:y0 + ih, x0 + iw - 5:x0 + iw - 1] = 0
        half = int(round(ih / 2.0 * float(np.clip(p, 0.0, 1.0))))
        color = (0, 255, 0) if p > threshold else (255, 0, 0)
        grid[y0 + ih // 2 - half:y0 + ih // 2 + half,
             x0 + iw - 4:x0 + iw - 2] = color
        # White separator on the row's top edge.
        grid[y0, x0:x0 + iw] = 255
    return grid


def assert_segmentation(scenes: np.ndarray, n_frames: int,
                        min_shot_len: int = 12) -> None:
    """Structural invariants of a scene list (reference assert_segmentation)."""
    scenes = np.asarray(scenes)
    assert scenes[0][0] == 0, 'first scene must start at 0'
    assert scenes[-1][1] == n_frames - 1, 'last scene must end at the tail'
    for i in range(len(scenes) - 1):
        assert scenes[i][1] + 1 == scenes[i + 1][0], \
            f'gap between scenes {i} and {i + 1}'
    if len(scenes) > 1:
        lens = scenes[:, 1] - scenes[:, 0] + 1
        assert (lens >= min_shot_len).all(), 'shot below minimum length'
