"""Empty-center filling (reference ``sc_handle_empty_centers``).

Port of ``retargetvid_tpu/ops/temporal.py:fill_empty_centers``
(``smartVidCrop.py:1221-1300``): each run of consecutive invalid centers is
filled from the next valid center if the run start is closer to a segment
start than the run end is to a segment end, else from the previous one.
The focus-stability freeze (``freeze_unstable_segments``) is not ported.
"""

from __future__ import annotations

import torch

__all__ = ["fill_empty_centers"]


def fill_empty_centers(dx, dy, valid, seg_starts, seg_ends, frame_mask):
    """Fill invalid centers of the (T,) series; see the module docstring.

    ``seg_starts``/``seg_ends``: (S,) selected-frame segment bounds, padded
    with a far sentinel; ``frame_mask``: (T,) real (non-padded) frames.
    """
    t = dx.shape[0]
    valid = valid & frame_mask
    idx = torch.arange(t, dtype=torch.int64, device=dx.device)
    neg = torch.full_like(idx, -1)

    prev_valid = torch.cummax(torch.where(valid, idx, neg), 0).values
    rev = torch.cummax(torch.where(valid, t - 1 - idx, neg).flip(0),
                       0).values.flip(0)
    next_valid = t - 1 - rev
    has_prev = prev_valid >= 0
    has_next = torch.cummax(torch.where(valid, idx, neg).flip(0),
                            0).values.flip(0) >= 0
    next_valid = torch.where(has_next, next_valid, 0)
    prev_valid_c = torch.where(has_prev, prev_valid, 0)

    run_start = prev_valid + 1
    run_end = torch.where(has_next, next_valid - 1, t - 1)

    seg_starts = seg_starts.to(torch.int64)
    seg_ends = seg_ends.to(torch.int64)
    d_start = torch.abs(run_start[:, None] - seg_starts[None, :]).min(1).values
    d_end = torch.abs(run_end[:, None] - seg_ends[None, :]).min(1).values

    use_next = (d_start < d_end) & has_next
    use_next = torch.where(has_prev, use_next, has_next)
    src = torch.where(use_next, next_valid, prev_valid_c)

    any_valid = valid.any()
    out_x = torch.where(valid, dx, torch.where(any_valid, dx[src], dx))
    out_y = torch.where(valid, dy, torch.where(any_valid, dy[src], dy))
    return out_x, out_y
