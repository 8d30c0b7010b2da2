"""Ingest on the device path: the two resizes and the frame-sampling rule.

Port of the device-path part of ``retargetvid_tpu/pipeline/ingest.py``
(``TRANSNET_H/W``, ``TRANS_THRESHOLD``, ``sal_dims``, ``_resize_kernel``,
``sample_frames``).  Decode, read batching and ``read_and_segment_video``
are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from retargetvid_tpu_torch.config import TRANS_THRESHOLD, sal_dims
from retargetvid_tpu_torch.models.transnet import INPUT_HEIGHT, INPUT_WIDTH
from retargetvid_tpu_torch.ops.resize import resize, round_half_up

__all__ = ["TRANSNET_H", "TRANSNET_W", "TRANS_THRESHOLD", "sal_dims",
           "sample_frames"]

TRANSNET_H = INPUT_HEIGHT
TRANSNET_W = INPUT_WIDTH


def _to_u8(v: torch.Tensor) -> torch.Tensor:
    return torch.clamp(round_half_up(v), 0, 255).to(torch.uint8)


def _resize_kernel(h: int, w: int, sal_h: int, sal_w: int):
    """The ingest's two resizes of (N, h, w, 3) uint8 frames: a function
    giving (27x48 TransNet frames, sal_h x sal_w saliency frames), both
    linear and quantized round-half-up to uint8."""

    def fn(frames: torch.Tensor):
        if tuple(frames.shape[1:]) != (h, w, 3):
            raise ValueError(f'frames must be (N, {h}, {w}, 3), got '
                             f'{tuple(frames.shape)}')
        tn = _to_u8(resize(frames, (TRANSNET_H, TRANSNET_W), 'linear',
                           channels_last=True))
        sal = _to_u8(resize(frames, (sal_h, sal_w), 'linear',
                            channels_last=True))
        return tn, sal

    return fn


def sample_frames(n_frames: int, trans_probs: np.ndarray, skip: int,
                  frame_count: int, start: int = 0,
                  prev_true_inds: Optional[list] = None):
    """Reference frame-selection rule over one batch (``:379-399``).

    Selects frame start+i when it is exactly ``skip`` after the last
    selected frame, follows a frame whose transition probability exceeded
    the threshold, is the first frame ever, or is the video's final frame.
    Returns (selected_local_indices, true_inds, map2orig_additions).
    """
    true_inds = prev_true_inds if prev_true_inds is not None else []
    selected = []
    map2orig = []
    total = len(true_inds) - 1
    for i in range(n_frames):
        f = start + i
        want = (f == true_inds[-1] + skip) if true_inds else True
        after_shot_change = f > 0 and bool(
            trans_probs[f - 1] > TRANS_THRESHOLD)
        if want or after_shot_change or f == frame_count - 1:
            total += 1
            selected.append(i)
            true_inds.append(f)
        map2orig.append(total)
    return selected, true_inds, map2orig
