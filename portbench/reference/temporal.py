"""Center-series repairs: empty-center filling and focus freezing.

Frozen copy of the port's version of ``retargetvid_tpu/ops/temporal.py:fill_empty_centers,
freeze_unstable_segments`` (reference ``sc_handle_empty_centers``,
``smartVidCrop.py:1221-1300``, and the focus-stability freeze,
``:2449-2473``): each run of consecutive invalid centers is filled from the
next valid center if the run start is closer to a segment start than the
run end is to a segment end, else from the previous one; a short span
between two focus jumps is frozen to its first center.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["fill_empty_centers", "frozen_spans", "freeze_unstable_segments"]


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


def frozen_spans(jump_inds, *, fc_sel: int, skip: int, fps: float,
                 stab_secs: float) -> list:
    """The [start, end) spans the focus freeze applies, in order.

    ``jump_inds``: the ascending jump indices, on the host.  Each
    consecutive pair (i, i+1) spans [jump_i - 1, jump_{i+1} + 1), clipped
    to [0, fc_sel - 1), and is frozen when its duration ``span * skip /
    fps`` is at most ``stab_secs``.  The duration is the JAX package's
    float32 value, which XLA computes as ``span * (skip * (1 / fps))`` with
    the constant factor folded in float32, so a span at the limit is
    decided as there (10 * 6 / 30 is 2.0000002 > 2.0, not frozen).
    """
    limit = np.float32(stab_secs)
    rate = np.float32(skip) * (np.float32(1.0) / np.float32(fps))
    spans = []
    for a, b in zip(jump_inds[:-1], jump_inds[1:]):
        start = max(int(a) - 1, 0)
        end = min(int(b) + 1, int(fc_sel) - 1)
        dur = np.float32(end - start) * rate
        if end > start and dur <= limit:
            spans.append((start, end))
    return spans


def freeze_unstable_segments(dx, dy, jump_inds, *, fc_sel: int, skip: int,
                             fps: float, stab_secs: float):
    """Freeze the (T,) center series over each of :func:`frozen_spans` in
    order: the span takes its first center, which an earlier span may
    already have frozen."""
    dx, dy = dx.clone(), dy.clone()
    for start, end in frozen_spans(jump_inds, fc_sel=fc_sel, skip=skip,
                                   fps=fps, stab_secs=stab_secs):
        dx[start:end] = dx[start].clone()
        dy[start:end] = dy[start].clone()
    return dx, dy
