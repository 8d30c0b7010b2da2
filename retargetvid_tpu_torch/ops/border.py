"""Border detection, mean saliency and coverage score.

Port of ``retargetvid_tpu/ops/border.py:border_detection, mean_saliency,
coverage_score`` (reference ``sc_border_detection``,
``smartVidCrop.py:842-924``, ``sc_compute_mean_sal``, ``:1304-1308``, and
``sc_compute_cvrg_score``, ``:1310-1331``): the leading and trailing
low-saliency rows and columns are counted from the time-max projection,
and the coverage window slides as a cumulative-sum difference.
"""

from __future__ import annotations

import torch

from retargetvid_tpu_torch.utils import timing

__all__ = ["border_detection", "mean_saliency", "coverage_score"]


def _leading_below(profile: torch.Tensor, t_border: int) -> torch.Tensor:
    """Count of leading entries <= ``t_border`` (stops at the first one
    above)."""
    above = profile > t_border
    n = torch.tensor(profile.shape[0], device=profile.device)
    timing.count('dispatch_syncs')          # the upload of n
    return torch.where(above.any(), torch.argmax(above.to(torch.uint8)), n)


def border_detection(smaps: torch.Tensor, t_border: int, h_orig: int,
                     w_orig: int) -> dict:
    """Constant low-saliency borders of a (T, H, W) volume, int32 0-d
    tensors in original-frame pixels: each side's leading count of rows or
    columns whose time-max stays <= ``t_border``, capped at 45% of its
    dimension and scaled with int truncation.  Zeros with
    ``t_border == -1``."""
    if t_border == -1:
        z = torch.zeros((), dtype=torch.int32, device=smaps.device)
        return {'border_t': z, 'border_b': z, 'border_l': z, 'border_r': z}
    h, w = smaps.shape[1:]
    sal_max = torch.amax(smaps, dim=0)
    f_col = torch.amax(sal_max, dim=1)             # per row -> top/bottom
    f_row = torch.amax(sal_max, dim=0)             # per column -> left/right
    cap_h, cap_w = int(h * 0.45), int(w * 0.45)
    sides = {'border_t': (f_col, cap_h, h_orig / h),
             'border_b': (f_col.flip(0), cap_h, h_orig / h),
             'border_l': (f_row, cap_w, w_orig / w),
             'border_r': (f_row.flip(0), cap_w, w_orig / w)}
    # float32 scale times the count, truncated: the JAX package's float32.
    return {k: (scale * torch.clamp(_leading_below(p, t_border), max=cap)
                .to(torch.float32)).to(torch.int32)
            for k, (p, cap, scale) in sides.items()}


def mean_saliency(smaps: torch.Tensor):
    """Global and per-frame mean saliency of a (T, H, W) volume."""
    smaps = smaps.to(torch.float32)
    return torch.mean(smaps), torch.mean(smaps, dim=(1, 2))


def coverage_score(smaps: torch.Tensor, conversion_mode: int,
                   window: int | None = None):
    """Best sliding-window share of the 1-D saliency projection per frame:
    (mean over frames, (T,) per frame).

    The projection is onto the cropped axis (columns for
    ``conversion_mode == 1``, else rows).  As in the reference, the window
    defaults to the whole projection, so the loop never runs and every
    score is 0; ``window`` gives the crop-window length.
    """
    smaps = smaps.to(torch.float32)
    t = smaps.shape[0]
    flat = smaps.sum(dim=1) if conversion_mode == 1 else smaps.sum(dim=2)
    n = flat.shape[1]
    win = n if window is None else int(window)
    if n - win <= 0:
        return (torch.zeros((), device=smaps.device),
                torch.zeros((t,), device=smaps.device))
    csum = torch.cat([torch.zeros((t, 1), device=smaps.device),
                      torch.cumsum(flat, dim=1)], dim=1)
    # Window sums at offsets 0..n-win-1 (the reference's range stops short
    # of the last offset).
    wsum = csum[:, win:n] - csum[:, :n - win]
    total = flat.sum(dim=1, keepdim=True)
    cvrg = torch.where(total > 0, wsum / torch.where(
        total > 0, total, torch.ones_like(total)), torch.zeros_like(wsum))
    per_frame = cvrg.amax(dim=1)
    return per_frame.mean(), per_frame
