"""Saliency thresholding (reference ``sc_threshold``, ``smartVidCrop.py:1050``)."""

from __future__ import annotations

import torch

__all__ = ["threshold_saliency"]


def threshold_saliency(smaps: torch.Tensor, t_threshold) -> torch.Tensor:
    """Zero saliency below ``t_threshold``; keeps dtype."""
    return torch.where(smaps < t_threshold, torch.zeros_like(smaps), smaps)
