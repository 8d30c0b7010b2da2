"""Filtering-through-clustering, batched over frames.

Port of ``retargetvid_tpu/ops/clustering.py:connected_components,
_adaptive_link_mask, _filter_one, clustering_filter`` (reference
``sc_clustering_filt``, ``smartVidCrop.py:1062-1161``): the nonzero pixels,
dilated to link near neighbours (a fixed ``bridge``, or per pixel by its
local density, see :func:`_adaptive_link_mask`), are labelled into
8-connected components; components with fewer than ``min_cluster_size``
true pixels are noise; the heaviest remaining component (largest single
value, or largest sum with ``select_sum == 1``) survives and every other
pixel is zeroed.  :func:`clustering_filter` adds the caller-side steps:
the ``resize_factor`` downscale and upscale, the close and the gates.

The labelling repeats the JAX sweep exactly -- a 3x3 masked min-pool, then
segmented cumulative minima along rows and columns in both directions --
with the same ``n_iters`` cap and early exit, so a shape that has not
converged after the cap gets the same labels as in JAX.  A label is its
component's smallest flat index; ties between components go to the lowest
label.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.nn import functional as F

from retargetvid_tpu_torch.ops.morphology import close as morph_close
from retargetvid_tpu_torch.ops.morphology import dilate
from retargetvid_tpu_torch.ops.resize import (
    RESIZE_TYPE_TO_METHOD,
    resize,
    resize_by_factor,
    round_half_up,
)
from retargetvid_tpu_torch.utils import timing

__all__ = ["connected_components", "filter_frames", "clustering_filter"]


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
    sweeps = 0
    for _ in range(n_iters):
        sweeps += 1
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
    # The label upload and each sweep's torch.equal wait for the device.
    timing.count('ccl_sweeps', sweeps)
    timing.count('dispatch_syncs', 1 + sweeps)
    return labels


def _box_count(m: torch.Tensor, r: int) -> torch.Tensor:
    """Sum of the int32 (T, H, W) map over each pixel's (2r+1)^2 box, zero
    outside the frame: integral-image differences, exact."""
    k = 2 * r + 1
    p = F.pad(m, (r + 1, r, r + 1, r))
    c = torch.cumsum(torch.cumsum(p, dim=1), dim=2)
    return c[:, k:, k:] - c[:, :-k, k:] - c[:, k:, :-k] + c[:, :-k, :-k]


def _adaptive_link_mask(mask: torch.Tensor, min_samples: int,
                        max_radius: int) -> torch.Tensor:
    """Density-adaptive dilation of a boolean (T, H, W) mask, emulating
    HDBSCAN's mutual-reachability linking.

    Each nonzero pixel's core radius is the smallest Chebyshev radius
    r = 1..``max_radius`` whose box holds >= ``min_samples`` other nonzero
    pixels (``max_radius + 1`` if none does); the pixel is dilated by
    ``(core + 1) // 2``, so dense blob interiors link like the 1-px bridge
    and sparse speckle chains across wider gaps.
    """
    m = mask.to(torch.int32)
    core = torch.full_like(m, max_radius + 1)
    for r in range(max_radius, 0, -1):
        cnt = _box_count(m, r) - m
        core = torch.where(cnt >= min_samples, torch.full_like(m, r), core)
    rho = torch.div(core + 1, 2, rounding_mode='floor')
    out = torch.zeros_like(mask)
    for radius in range(0, (max_radius + 2) // 2 + 1):
        sel = mask & (rho == radius)
        if radius == 0:
            out = out | sel
        else:
            out = out | (dilate(sel.to(torch.float32), 2 * radius + 1) > 0.5)
    return out


def filter_frames(smaps: torch.Tensor, *, min_cluster_size: int,
                  select_sum: int, bridge: int, cc_iters: int,
                  adaptive_min_samples: Optional[int] = None,
                  adaptive_max_radius: int = 4):
    """Cluster-filter a (T, H, W) float32 saliency volume.

    Returns ``(filtered, any_valid, n_points)`` per frame, as the JAX
    ``_filter_one`` does for one frame: the caller applies the
    ``n_points > hdbscan_min + 1`` gate and the morphological close.
    Pixels link by :func:`_adaptive_link_mask` when
    ``adaptive_min_samples`` is given, else by a ``bridge``-px dilation.
    """
    t, h, w = smaps.shape
    n_px = h * w
    mask = smaps > 0
    if adaptive_min_samples is not None:
        link_mask = _adaptive_link_mask(mask, adaptive_min_samples,
                                        adaptive_max_radius)
    elif bridge > 0:
        link_mask = dilate(mask.to(torch.float32), 2 * bridge + 1) > 0.5
    else:
        link_mask = mask
    labels = connected_components(link_mask, n_iters=cc_iters)
    n_px_t = torch.tensor(n_px, dtype=torch.int32, device=smaps.device)
    timing.count('dispatch_syncs')          # the upload of n_px
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


def clustering_filter(smaps: torch.Tensor, *, min_cluster_size: int = 26,
                      select_sum: int = 2, resize_factor: float = 1.0,
                      resize_type: int = 1, op_close: bool = True,
                      bridge: int = 1, cc_iters: int = 12,
                      min_points: Optional[int] = None,
                      adaptive_min_samples: Optional[int] = None,
                      adaptive_max_radius: int = 4) -> torch.Tensor:
    """The clustering filter of a (T, H, W) saliency volume, float32 out.

    With ``resize_factor != 1`` the maps are downscaled by ``resize_type``
    (cv2 ``fx=1/factor`` form) and quantized to uint8 values, filtered,
    then upscaled bilinearly to (H, W) and quantized again.  Frames with
    ``<= min_points`` nonzero pixels (default ``min_cluster_size + 1``) or
    no cluster pass through unfiltered; ``op_close`` closes the surviving
    blob with a 5x5 element.
    """
    smaps = smaps.to(torch.float32)
    h, w = smaps.shape[1:]
    if min_points is None:
        min_points = min_cluster_size + 1
    work = smaps
    if resize_factor != 1.0:
        method = RESIZE_TYPE_TO_METHOD.get(resize_type, 'linear')
        work = torch.clamp(round_half_up(resize_by_factor(
            smaps, resize_factor, method, channels_last=False)), 0, 255)
    filtered, any_valid, n_points = filter_frames(
        work, min_cluster_size=min_cluster_size, select_sum=select_sum,
        bridge=bridge, cc_iters=cc_iters,
        adaptive_min_samples=adaptive_min_samples,
        adaptive_max_radius=adaptive_max_radius)
    if op_close:
        filtered = torch.where(any_valid[:, None, None],
                               morph_close(filtered, 5), filtered)
    use = (n_points > min_points) & any_valid
    out = torch.where(use[:, None, None], filtered, work)
    if resize_factor != 1.0:
        out = torch.clamp(round_half_up(resize(
            out, (h, w), 'linear', channels_last=False)), 0, 255)
    return out
