"""Saliency-model input: network grid and preprocessing.

Port of ``retargetvid_tpu/pipeline/saliency.py:get_optimal_out_size,
preprocess_frames`` (reference ``unisal/data.py:1086-1103, 1241-1313``):
PIL-LANCZOS resize to a x32 grid (with PIL's uint8 rounding), /255 and
ImageNet normalisation.
"""

from __future__ import annotations

from typing import Tuple

import torch

from retargetvid_tpu_torch.ops.resize import resize, round_half_up

__all__ = ["get_optimal_out_size", "preprocess_frames", "IMAGENET_MEAN",
           "IMAGENET_STD"]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def get_optimal_out_size(img_size: Tuple[int, int]) -> Tuple[int, int]:
    """The x32 network grid best matching the aspect ratio: (n1, n2) in
    [7, 13]^2 with 100 <= n1*n2 <= 120, times 32."""
    ar = img_size[0] / img_size[1]
    best, best_ratio = None, -1.0
    for n1 in range(7, 14):
        for n2 in range(7, 14):
            if 100 <= n1 * n2 <= 120:
                this_ar = n1 / n2
                ratio = min(ar, this_ar) / max(ar, this_ar)
                if ratio > best_ratio:
                    best_ratio = ratio
                    best = (n1, n2)
    return (best[0] * 32, best[1] * 32)


def preprocess_frames(frames: torch.Tensor,
                      out_size: Tuple[int, int]) -> torch.Tensor:
    """uint8 (B, H, W, 3) -> normalised float32 (B, h, w, 3)."""
    x = resize(frames, out_size, 'lanczos', channels_last=True)
    x = torch.clamp(round_half_up(x), 0, 255) / 255.0
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32,
                        device=frames.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32,
                       device=frames.device)
    return (x - mean) / std
