"""Border detection and mean saliency.

Port of ``retargetvid_tpu/ops/border.py:border_detection, mean_saliency``
(reference ``sc_border_detection``, ``smartVidCrop.py:842-924``, and
``sc_compute_mean_sal``, ``:1304-1308``).  Both crop presets disable border
detection (``t_border == -1``), and only that setting is ported.
"""

from __future__ import annotations

import torch

__all__ = ["border_detection", "mean_saliency"]


def border_detection(smaps: torch.Tensor, t_border: int, h_orig: int,
                     w_orig: int) -> dict:
    """Borders in original-frame pixels; zeros with ``t_border == -1``."""
    if t_border != -1:
        raise NotImplementedError(
            'border detection (t_border != -1) is not ported yet')
    z = torch.zeros((), dtype=torch.int32, device=smaps.device)
    return {'border_t': z, 'border_b': z, 'border_l': z, 'border_r': z}


def mean_saliency(smaps: torch.Tensor):
    """Global and per-frame mean saliency of a (T, H, W) volume."""
    smaps = smaps.to(torch.float32)
    return torch.mean(smaps), torch.mean(smaps, dim=(1, 2))
