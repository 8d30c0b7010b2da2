"""Grayscale morphology with a square structuring element.

Frozen copy of the port's version of ``retargetvid_tpu/ops/morphology.py`` (cv2 ``MORPH_CLOSE`` with a
5x5 all-ones element, ``smartVidCrop.py:1127-1128``): dilation is a
max-pool whose border never brightens (padding -inf), erosion a min-pool
whose border never darkens (+inf), close is dilate then erode.  Works on
(..., H, W) maps of any float or integer dtype, in float32.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F

__all__ = ["dilate", "erode", "close"]


def _max_pool(x: torch.Tensor, ksize: int) -> torch.Tensor:
    shape = x.shape
    xf = x.to(torch.float32).reshape(-1, 1, shape[-2], shape[-1])
    out = F.max_pool2d(xf, ksize, stride=1, padding=ksize // 2)
    return out.reshape(shape)


def dilate(x: torch.Tensor, ksize: int = 5) -> torch.Tensor:
    return _max_pool(x, ksize).to(x.dtype)


def erode(x: torch.Tensor, ksize: int = 5) -> torch.Tensor:
    return (-_max_pool(-x.to(torch.float32), ksize)).to(x.dtype)


def close(x: torch.Tensor, ksize: int = 5) -> torch.Tensor:
    """Morphological closing: dilate then erode (cv2.MORPH_CLOSE parity)."""
    return erode(dilate(x, ksize), ksize)
