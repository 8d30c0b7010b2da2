"""Filtering-through-clustering, batched over frames.

Port of ``retargetvid_tpu/ops/clustering.py:connected_components,
_filter_one`` with the fixed ``bridge`` dilation (reference
``sc_clustering_filt``, ``smartVidCrop.py:1062-1161``): the nonzero pixels,
dilated by ``bridge`` to link near neighbours, are labelled into
8-connected components; components with fewer than ``min_cluster_size``
true pixels are noise; the heaviest remaining component (largest single
value, or largest sum with ``select_sum == 1``) survives and every other
pixel is zeroed.

The labelling repeats the JAX sweep exactly -- a 3x3 masked min-pool, then
segmented cumulative minima along rows and columns in both directions --
with the same ``n_iters`` cap and early exit, so a shape that has not
converged after the cap gets the same labels as in JAX.  A label is its
component's smallest flat index; ties between components go to the lowest
label.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F

from retargetvid_tpu_torch.ops.morphology import dilate

__all__ = ["connected_components", "filter_frames"]


def _min_pool3(x: torch.Tensor, big: int) -> torch.Tensor:
    """3x3 min-pool of (T, H, W) int labels; outside the frame counts as
    ``big``.  Separable: a min over columns, then over rows."""
    p = F.pad(x, (1, 1, 1, 1), value=big)
    c = torch.minimum(torch.minimum(p[:, :, :-2], p[:, :, 1:-1]), p[:, :, 2:])
    return torch.minimum(torch.minimum(c[:, :-2], c[:, 1:-1]), c[:, 2:])


def _segmented_cummin(vals: torch.Tensor, reset: torch.Tensor, dim: int,
                      big: int, reverse: bool = False) -> torch.Tensor:
    """Per-run cumulative min along ``dim``; a run starts at each ``reset``.

    Each run is lifted by ``(n_runs_after) * big`` so that a plain cummin
    never carries a value from an earlier run into a later one; the lift is
    taken off afterwards.  Values must lie in [0, big).
    """
    if reverse:
        vals, reset = vals.flip(dim), reset.flip(dim)
    seg = torch.cumsum(reset.to(torch.int64), dim=dim)
    last = seg.narrow(dim, vals.shape[dim] - 1, 1)
    lift = (last - seg) * big
    out = torch.cummin(vals.to(torch.int64) + lift, dim=dim).values - lift
    out = out.to(vals.dtype)
    return out.flip(dim) if reverse else out


def connected_components(mask: torch.Tensor, n_iters: int = 12):
    """8-connected component labels of a boolean (T, H, W) mask.

    Each foreground pixel gets the smallest flat index of its component
    (within ``n_iters`` sweeps); background pixels get H*W.
    """
    t, h, w = mask.shape
    bg = h * w
    big = bg + 1
    flat_idx = torch.arange(h * w, dtype=torch.int32,
                            device=mask.device).reshape(1, h, w)
    bg_t = torch.tensor(bg, dtype=torch.int32, device=mask.device)
    labels = torch.where(mask, flat_idx, bg_t)
    reset = ~mask
    for _ in range(n_iters):
        new = torch.where(mask, torch.minimum(labels, _min_pool3(labels, big)),
                          bg_t)
        new = _segmented_cummin(new, reset, 2, big)
        new = _segmented_cummin(new, reset, 2, big, reverse=True)
        new = _segmented_cummin(new, reset, 1, big)
        new = _segmented_cummin(new, reset, 1, big, reverse=True)
        new = torch.where(mask, new, bg_t)
        # Labels only decrease: a sweep that changes nothing is the
        # fixpoint, and every later sweep would be a no-op.
        if torch.equal(new, labels):
            break
        labels = new
    return labels


def filter_frames(smaps: torch.Tensor, *, min_cluster_size: int,
                  select_sum: int, bridge: int, cc_iters: int):
    """Cluster-filter a (T, H, W) float32 saliency volume.

    Returns ``(filtered, any_valid, n_points)`` per frame, as the JAX
    ``_filter_one`` does for one frame: the caller applies the
    ``n_points > hdbscan_min + 1`` gate and the morphological close.
    """
    t, h, w = smaps.shape
    n_px = h * w
    mask = smaps > 0
    if bridge > 0:
        link_mask = dilate(mask.to(torch.float32), 2 * bridge + 1) > 0.5
    else:
        link_mask = mask
    labels = connected_components(link_mask, n_iters=cc_iters)
    n_px_t = torch.tensor(n_px, dtype=torch.int32, device=smaps.device)
    labels = torch.where(mask, labels, n_px_t).reshape(t, n_px).to(
        torch.int64)
    vals = torch.clamp(smaps.reshape(t, n_px), 0, 255).to(torch.int64)

    # Per-component size and weight, in a (T, H*W + 1) table by label.
    sizes = torch.zeros((t, n_px + 1), dtype=torch.int64, device=smaps.device)
    sizes.scatter_add_(1, labels, torch.ones_like(labels))
    weights = torch.zeros_like(sizes)
    if select_sum == 1:
        weights.scatter_add_(1, labels, vals)
    else:
        weights.scatter_reduce_(1, labels, vals, reduce='amax')
    valid = sizes >= min_cluster_size
    valid[:, n_px] = False                      # the background "component"
    any_valid = valid.any(dim=1)
    # argmax takes the first maximum: the lowest label wins ties.  With no
    # valid component JAX's sorted-run argmax lands on the smallest label.
    winner = torch.where(any_valid,
                         torch.argmax(torch.where(valid, weights, -1), dim=1),
                         labels.min(dim=1).values)
    keep = labels == winner[:, None]
    filtered = torch.where(keep.reshape(t, h, w), smaps,
                           torch.zeros_like(smaps))
    n_points = mask.reshape(t, n_px).sum(dim=1)
    return filtered, any_valid, n_points
