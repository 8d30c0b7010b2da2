"""Focus-jump saliency scores (focus stability, ISM-2021).

Frozen copy of the port's version of ``retargetvid_tpu/ops/focus.py:_line_score, jump_saliency_scores``
(reference ``get_points_on_line`` + ``sc_check_for_extra_cuts``,
``smartVidCrop.py:1337-1455``): for each pair of consecutive focus centers
the saliency map is sampled along the line between them (unit steps along
the major axis, the minor axis by truncated slope) and averaged; a low mean
says the focus jumped across a non-salient region.  All frames' lines are
one batched (T-1, max_pts) computation: positions, a gather and a masked
mean, with the JAX package's float32 operations in its order.
"""

from __future__ import annotations

import torch

__all__ = ["jump_saliency_scores"]


def jump_saliency_scores(smaps: torch.Tensor, cx: torch.Tensor,
                         cy: torch.Tensor, *, min_d_jump: float,
                         max_pts: int | None = None) -> torch.Tensor:
    """Line scores between consecutive centers of a (T, H, W) volume.

    Returns (T,) float32: entry 0 is 255 (no previous center); entry t
    scores the move from center t-1 to center t over frame t's map, 255
    where the move is shorter than ``min_d_jump`` on both axes or no point
    of the line lies in the frame.
    """
    smaps = smaps.to(torch.float32)
    t, h, w = smaps.shape
    dev = smaps.device
    if max_pts is None:
        max_pts = max(h, w)
    p1x, p1y = cx[:-1, None], cy[:-1, None]
    p2x, p2y = cx[1:, None], cy[1:, None]
    dx, dy = p2x - p1x, p2y - p1y
    dxa, dya = torch.abs(dx), torch.abs(dy)
    small = (dxa < min_d_jump) & (dya < min_d_jump)
    n_pts = torch.ceil(torch.maximum(dxa, dya)).to(torch.int32)

    k = torch.arange(max_pts, dtype=torch.float32, device=dev)[None, :]
    steep = dya > dxa
    one = torch.ones_like(dx)
    # Major-axis positions p +- (k+1), keeping the center's fraction.
    step_y = torch.where(dy < 0, -one, one)
    step_x = torch.where(dx < 0, -one, one)
    ys_major = p1y + step_y * (k + 1)
    xs_major = p1x + step_x * (k + 1)
    # Minor-axis positions by the truncated slope (reference .astype(int)).
    zero = torch.zeros_like(dx)
    slope_x = torch.where(dy != 0, dx / torch.where(dy != 0, dy, one), zero)
    slope_y = torch.where(dx != 0, dy / torch.where(dx != 0, dx, one), zero)
    xs_steep = torch.trunc(slope_x * (ys_major - p1y)) + p1x
    ys_flat = torch.trunc(slope_y * (xs_major - p1x)) + p1y
    xs = torch.where(steep, xs_steep, xs_major)
    ys = torch.where(steep, ys_major, ys_flat)

    in_line = k < n_pts.to(torch.float32)
    in_img = (xs >= 0) & (ys >= 0) & (xs < w) & (ys < h)
    valid = in_line & in_img
    ii = torch.clamp(torch.floor(xs).to(torch.int64), 0, w - 1)
    jj = torch.clamp(torch.floor(ys).to(torch.int64), 0, h - 1)
    vals = torch.gather(smaps[1:].reshape(t - 1, h * w), 1, jj * w + ii)

    # Integer values below 2**24 in total: the sum is exact in any order.
    count = valid.sum(dim=1, keepdim=True).to(torch.float32)
    total = torch.where(valid, vals, torch.zeros_like(vals)).sum(
        dim=1, keepdim=True)
    full = torch.full_like(total, 255.0)
    mean = torch.where(count > 0, total / torch.clamp(count, min=1.0), full)
    score = torch.where(small, full, mean)[:, 0]
    return torch.cat([torch.full((1,), 255.0, device=dev), score])
