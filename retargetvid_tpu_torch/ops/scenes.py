"""Shot-probability to scene-list conversion (host, numpy).

Port of ``retargetvid_tpu/ops/scenes.py`` (reference
``smartVidCrop.py:214-230`` plus the boundary fix at ``:459-464``):
threshold transition probabilities, emit [start, end] spans of
below-threshold runs, fall back to one full-length scene when every frame
is a "transition", then stretch each scene's end to meet the next scene's
start.  Scene lists are a handful of rows that drive the host-side segment
layout of the two-dispatch path, so they stay numpy.
"""

from __future__ import annotations

import numpy as np

__all__ = ["predictions_to_scenes", "fix_scene_bounds", "scenes_to_selected",
           "insert_cuts"]


def predictions_to_scenes(predictions, threshold: float = 0.5) -> np.ndarray:
    """Scene [start, end] spans from per-frame transition probabilities."""
    preds = (np.asarray(predictions) > threshold).astype(np.uint8)
    scenes = []
    t, t_prev, start = -1, 0, 0
    for i, t in enumerate(preds):
        if t_prev == 1 and t == 0:
            start = i
        if t_prev == 0 and t == 1 and i != 0:
            scenes.append([start, i])
        t_prev = t
    if t == 0:
        scenes.append([start, i])
    if len(scenes) == 0:
        return np.array([[0, len(preds) - 1]], dtype=np.int32)
    return np.array(scenes, dtype=np.int32)


def fix_scene_bounds(segmentation, true_frame_count: int) -> np.ndarray:
    """Make segment i end at segment i+1's start minus one and pin the last
    end to the final frame (the raw list leaves transition frames
    unassigned)."""
    seg = np.array(segmentation, dtype=np.int32, copy=True)
    for i in range(seg.shape[0] - 1):
        seg[i][1] = seg[i + 1][0] - 1
    seg[-1][1] = true_frame_count - 1
    return seg


def insert_cuts(segmentation, segmentation_sel, true_inds,
                extra_cuts_at, extra_cuts_scores,
                no_extra_cuts: int = 10):
    """Merge extra (focus-change) cuts into both segmentations.

    Reference ``sc_insert_cuts`` (``smartVidCrop.py:1457-1522``): sort the
    candidates by score ascending and DROP the first ``no_extra_cuts`` (a
    reference quirk kept as is), union the rest with the existing
    selected-frame cuts, and rebuild the selected-frame and true-frame
    segment tables.  Returns (segmentation, segmentation_sel, kept_cuts,
    kept_scores).
    """
    extra_cuts_at = list(extra_cuts_at)
    extra_cuts_scores = list(extra_cuts_scores)
    if no_extra_cuts is not None:
        order = np.argsort(extra_cuts_scores, kind='stable')
        extra_cuts_at = [extra_cuts_at[i] for i in order][no_extra_cuts:]
        extra_cuts_scores = sorted(extra_cuts_scores)[no_extra_cuts:]

    seg_sel = np.asarray(segmentation_sel)
    old_cuts = [int(s[0]) for s in seg_sel]
    cuts = sorted(set(old_cuts + [int(c) for c in extra_cuts_at]))

    old_end_sel = int(seg_sel[-1][1])
    new_sel = [[cuts[i], cuts[i + 1] - 1] for i in range(len(cuts) - 1)]
    new_sel.append([cuts[-1], old_end_sel])

    true_inds = np.asarray(true_inds)
    true_cuts = [int(true_inds[c]) for c in cuts]
    old_end = int(np.asarray(segmentation)[-1][1])
    new_seg = [[true_cuts[i], true_cuts[i + 1] - 1]
               for i in range(len(true_cuts) - 1)]
    new_seg.append([true_cuts[-1], old_end])

    return (np.array(new_seg, np.int32), np.array(new_sel, np.int32),
            extra_cuts_at, extra_cuts_scores)


def scenes_to_selected(segmentation, map2orig) -> np.ndarray:
    """Map a true-frame scene list to selected-frame indices (reference
    ``smartVidCrop.py:470-474``: each bound becomes ``map2orig`` of it)."""
    seg = np.array(segmentation, dtype=np.int32, copy=True)
    return np.asarray(map2orig)[seg].astype(np.int32)
