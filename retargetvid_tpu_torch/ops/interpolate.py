"""Per-segment center interpolation to every true frame.

Port of ``retargetvid_tpu/ops/interpolate.py:interpolate_segments``
(reference ``interp_handler``/``sc_interpolate``,
``smartVidCrop.py:1528-1597``), batched over segments: fewer than 3 samples
repeat the first value, 3..6 samples interpolate linearly with
extrapolation, 7 or more use scipy's ``interp1d(kind='quadratic')`` -- a
quadratic B-spline with not-a-knot knots, solved as a padded collocation
system (identity rows past the live sample count) and evaluated with de
Boor's recursion, extrapolating past the ends.
"""

from __future__ import annotations

import torch

from retargetvid_tpu_torch.utils import timing

__all__ = ["interpolate_segments"]

_K = 2          # quadratic
_BIG = 1e12     # knot padding sentinel


def _safe_div(a, b):
    return a / torch.where(b == 0, torch.ones_like(b), b)


def _take(t: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """Row-wise gather t[s, i[s, ...]] for (S, N) ``t`` and (S, ...) ``i``."""
    s = t.shape[0]
    return torch.gather(t, 1, i.reshape(s, -1)).reshape(i.shape)


def _build_knots(xs, n, max_n):
    """Not-a-knot quadratic knots, (S, max_n + 3): x0 x3, midpoints of
    x[j], x[j+1] for j = 1..n-3, xe x3, then the sentinel."""
    x0 = xs[:, :1]
    xe = _take(xs, torch.clamp(n - 1, min=0)[:, None])
    p = torch.arange(max_n + 3, device=xs.device)[None, :]
    mid_lo = _take(xs, torch.clamp(p - 2, 0, max_n - 1).expand(xs.shape[0], -1))
    mid_hi = _take(xs, torch.clamp(p - 1, 0, max_n - 1).expand(xs.shape[0], -1))
    mids = 0.5 * (mid_lo + mid_hi)
    nn_ = n[:, None]
    big = torch.full_like(mids, _BIG)
    return torch.where(p < 3, x0, torch.where(
        p < nn_, mids, torch.where(p < nn_ + 3, xe, big)))


def _bsplvb(t, i, x):
    """The 3 quadratic B-spline bases active on interval ``i`` at ``x``
    (de Boor's BSPLVB; a polynomial extension outside [t[i], t[i+1])).
    ``t`` (S, M); ``i``, ``x`` (S, L).  Returns (S, L, 3) for bases
    i-2, i-1, i."""
    vals = [torch.ones_like(x), torch.zeros_like(x), torch.zeros_like(x)]
    for d in range(1, _K + 1):
        saved = torch.zeros_like(x)
        new_vals = list(vals)
        for r in range(d):
            right = _take(t, i + r + 1) - x
            left = x - _take(t, i + 1 - (d - r))
            term = _safe_div(vals[r], right + left)
            new_vals[r] = saved + right * term
            saved = left * term
        new_vals[d] = saved
        vals = new_vals
    return torch.stack(vals, dim=-1)


def _interval_index(t, x, n):
    """Largest i with t[i] <= x, clamped to [k, n-1]."""
    i = torch.searchsorted(t, x.contiguous(), right=True) - 1
    hi = torch.clamp(n - 1, min=_K)[:, None]
    return torch.minimum(torch.clamp(i, min=_K), hi)


def _quadratic_spline(xs, ys, n, x_eval, max_n):
    """scipy interp1d(kind='quadratic', fill_value='extrapolate') parity.
    Garbage (possibly non-finite) where n < 3; callers select it away."""
    s = xs.shape[0]
    t = _build_knots(xs, n, max_n)
    ii = _interval_index(t, xs, n)                       # (S, max_n)
    basis = _bsplvb(t, ii, xs)                           # (S, max_n, 3)
    rows = torch.arange(max_n, device=xs.device)
    offs = torch.tensor([2, 1, 0], device=xs.device)
    timing.count('dispatch_syncs')          # the upload of offs
    cols = torch.clamp(ii[..., None] - offs, 0, max_n - 1)
    live = rows[None, :] < n[:, None]                    # (S, max_n)
    mat = torch.zeros((s, max_n, max_n), dtype=xs.dtype, device=xs.device)
    mat.scatter_add_(2, cols, torch.where(live[..., None], basis,
                                          torch.zeros_like(basis)))
    eye = torch.eye(max_n, dtype=xs.dtype, device=xs.device)
    mat = torch.where(live[..., None], mat, eye)
    rhs = torch.where(live, ys, torch.zeros_like(ys))
    # solve_ex: a singular system (dead lanes) yields non-finite values, as
    # in JAX, instead of raising.
    coefs = torch.linalg.solve_ex(mat, rhs[..., None])[0][..., 0]

    ie = _interval_index(t, x_eval, n)                   # (S, L)
    be = _bsplvb(t, ie, x_eval)                          # (S, L, 3)
    ce = _take(coefs, torch.clamp(ie[..., None] - offs, 0, max_n - 1))
    return torch.sum(be * ce, dim=-1)


def _linear_extrap(xs, ys, n, x_eval, max_n):
    """Linear interpolation with end extrapolation (interp1d 'linear')."""
    samp = torch.arange(max_n, device=xs.device)[None, :]
    xs_pad = torch.where(samp < n[:, None], xs, torch.full_like(xs, _BIG))
    j = torch.searchsorted(xs_pad, x_eval.contiguous(), right=True) - 1
    j = torch.minimum(torch.clamp(j, min=0),
                      torch.clamp(n - 2, min=0)[:, None])
    j1 = torch.clamp(j + 1, max=max_n - 1)
    x0, x1 = _take(xs_pad, j), _take(xs_pad, j1)
    y0, y1 = _take(ys, j), _take(ys, j1)
    slope = _safe_div(y1 - y0, x1 - x0)
    return y0 + slope * (x_eval - x0)


def interpolate_segments(d_sel, true_inds, seg_starts, seg_ends,
                         seg_sel_starts, seg_sel_ends, n_segments,
                         t_out: int, max_samples: int, max_len: int):
    """Up-sample selected-frame centers to every true frame, per segment.

    ``d_sel`` (T_sel,) centers; ``true_inds`` (T_sel,) their true frame
    indices; segment bounds (S,) inclusive, live for the first
    ``n_segments``.  Returns the (t_out,) float32 series.
    """
    dev = d_sel.device
    d_sel = d_sel.to(torch.float32)
    true_inds = true_inds.to(torch.int64)
    s = seg_starts.shape[0]
    t_sel = d_sel.shape[0]
    live = torch.arange(s, device=dev) < n_segments
    sis = seg_sel_starts.to(torch.int64)
    n = torch.where(live, seg_sel_ends.to(torch.int64) - sis + 1,
                    torch.zeros_like(sis))
    samp = torch.arange(max_samples, device=dev)[None, :]
    gather = torch.clamp(sis[:, None] + samp, 0, t_sel - 1)
    xs_raw = true_inds[gather].to(torch.float32)
    base = xs_raw[:, :1]
    nm1 = torch.clamp(n - 1, min=0)[:, None]
    xs = torch.where(samp < n[:, None], xs_raw - base,
                     (_take(xs_raw, nm1) - base) + samp.to(torch.float32))
    last = d_sel[torch.clamp(sis[:, None] + nm1, 0, t_sel - 1)]
    ys = torch.where(samp < n[:, None], d_sel[gather], last)
    x_eval = torch.arange(max_len, dtype=torch.float32,
                          device=dev)[None, :].expand(s, -1)

    quad = _quadratic_spline(xs, ys, n, x_eval, max_samples)
    lin = _linear_extrap(xs, ys, n, x_eval, max_samples)
    rep = ys[:, :1].expand(-1, max_len)
    nn_ = n[:, None]
    vals = torch.where(nn_ < 3, rep, torch.where(nn_ <= 6, lin, quad))

    si = seg_starts.to(torch.int64)
    seg_len = torch.where(live, seg_ends.to(torch.int64) - si + 1,
                          torch.zeros_like(si))
    local = torch.arange(max_len, device=dev)[None, :]
    mask = (local < seg_len[:, None]) & live[:, None]
    out = torch.zeros((t_out,), dtype=torch.float32, device=dev)
    out.index_add_(0, torch.clamp(si[:, None] + local, 0, t_out - 1).reshape(-1),
                   torch.where(mask, vals, torch.zeros_like(vals)).reshape(-1))
    return out
