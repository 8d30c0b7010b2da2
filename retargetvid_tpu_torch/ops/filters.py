"""Temporal smoothing of the center series: Butterworth filtfilt, then
LOESS or Savitzky-Golay.

Port of ``retargetvid_tpu/ops/filters.py:butter_lowpass_filter,
savgol_smooth, loess_smooth, smooth_segments`` (reference
``smartVidCrop.py:1599-1734``), batched over segments and the two axes:

- **Butterworth filtfilt**: the design is scipy's, on the host, as
  second-order sections.  Each pass runs the sections' recurrences
  ``s_n = M s_{n-1} + v x_n``, ``y_n = b0 x_n + s_{n-1}[0]`` sequentially
  over time (an associative-scan form was 8 px off in float32, see
  ``docs/COMPONENTS.md``), with scipy's odd-extension padding and
  ``sosfilt_zi`` initial states; segments shorter than the pad length take
  the reference's box-filter fallback.  The extension and both passes are
  ``kernels/filtfilt.py:butter_filtfilt``: one launch of a CUDA kernel on
  the card, the plain op chain on the CPU.
- **LOESS**: the reference's nearest-``w`` window is a contiguous range for
  uniformly spaced samples, so each position is a tricube-weighted
  quadratic least-squares fit, solved in a window-centred, scaled basis on
  mean-centred values with one step of iterative refinement (the raw basis
  was 15 px off in float32).
- **Savitzky-Golay** (``loess_filt=0``): the window is data (``min(fps*w,
  cl-2)`` forced odd), so scipy's coefficients and the ``interp`` edge
  fits (least-squares projections over the first and last window) are
  built on the host for every reachable odd window, zero-padded to the
  widest; each row gathers its window's rows and applies them at once.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch.nn import functional as F

from retargetvid_tpu_torch.kernels.filtfilt import butter_filtfilt
from retargetvid_tpu_torch.utils import timing

__all__ = ["butter_lowpass_filter", "savgol_smooth", "loess_smooth",
           "smooth_segments"]


def _safe_div(a, b):
    return a / torch.where(b == 0, torch.ones_like(b), b)


@functools.lru_cache(maxsize=64)
def _butter_design(cutoff: float, fs: float, order: int):
    """Butterworth low-pass as second-order sections (host, scipy).

    Returns ``(padlen, sections)``, each section ``(b0, M (2, 2), v (2,),
    zi (2,))`` as Python floats of the float32 values the JAX package uses.
    """
    from scipy import signal
    nyq = 0.5 * fs
    b, a = signal.butter(order, cutoff / nyq, btype='lowpass', analog=False)
    padlen = 3 * max(len(a), len(b))
    sos = signal.butter(order, cutoff / nyq, btype='lowpass', output='sos')
    zi_all = signal.sosfilt_zi(sos)
    sections = []
    for k in range(sos.shape[0]):
        b0, b1, b2, _, a1, a2 = sos[k]
        m = np.array([[-a1, 1.0], [-a2, 0.0]], np.float32)
        v = np.array([b1 - a1 * b0, b2 - a2 * b0], np.float32)
        sections.append((float(np.float32(b0)), m.tolist(), v.tolist(),
                         zi_all[k].astype(np.float32).tolist()))
    return padlen, tuple(sections)


def butter_lowpass_filter(x: torch.Tensor, n: torch.Tensor, cutoff: float,
                          fs: float, order: int) -> torch.Tensor:
    """scipy ``filtfilt`` on (B, L) padded series with live lengths ``n``
    (B,); short series (``n <= padlen``) take the box-5 fallback."""
    L = x.shape[1]
    dev = x.device
    padlen, sections = _butter_design(float(cutoff), float(fs), int(order))
    nn_ = n.to(torch.int64)[:, None]
    filt = butter_filtfilt(x, n, padlen, sections)

    # Reference fallback for short segments: box-5 mean of the interior.
    pos = torch.arange(L, device=dev)[None, :]
    xz = torch.where(pos < nn_, x, torch.zeros_like(x))
    box = F.conv1d(xz[:, None], torch.ones((1, 1, 5), dtype=x.dtype,
                                           device=dev), padding=2)[:, 0] / 5.0
    fallback = torch.where((pos >= 2) & (pos < nn_ - 2), box, x)
    return torch.where(nn_ > padlen, filt, fallback)


@functools.lru_cache(maxsize=256)
def _savgol_bank(window: int, degree: int):
    """scipy ``savgol_coeffs`` and the (half, window) head and tail rows of
    the edge fit's projection, float32 numpy (the JAX package's values)."""
    from scipy.signal import savgol_coeffs
    coeffs = savgol_coeffs(window, degree)
    half = window // 2
    vand = np.vander(np.arange(window), degree + 1, increasing=True)
    proj = vand @ np.linalg.pinv(vand)
    return (coeffs.astype(np.float32), proj[:half].astype(np.float32),
            proj[window - half:].astype(np.float32))


@functools.lru_cache(maxsize=16)
def _savgol_banks(windows: tuple, degree: int):
    """Every window's coefficients, centred in the widest window, and its
    head/tail rows in the leading corner: (NB, W), (NB, W//2, W) x 2."""
    wmax = max(windows)
    hmax = wmax // 2
    coeffs = np.zeros((len(windows), wmax), np.float32)
    head = np.zeros((len(windows), hmax, wmax), np.float32)
    tail = np.zeros_like(head)
    for b, win in enumerate(windows):
        c, hd, tl = _savgol_bank(win, degree)
        half = win // 2
        coeffs[b, hmax - half:hmax + half + 1] = c
        head[b, :half, :win] = hd
        tail[b, :half, :win] = tl
    return coeffs, head, tail


def savgol_smooth(x: torch.Tensor, n: torch.Tensor, window: torch.Tensor,
                  degree: int, window_bank: tuple) -> torch.Tensor:
    """``savgol_filter(x[:n], window, degree, mode='interp')`` per row of
    the (B, L) padded series, each with its live length ``n`` and odd
    ``window`` (B,).  A row whose window is not in ``window_bank`` (odd,
    ascending from 5 by 2) is returned as it is."""
    b, L = x.shape
    dev = x.device
    c_np, h_np, t_np = _savgol_banks(tuple(window_bank), degree)
    wmax = c_np.shape[1]
    hmax = wmax // 2
    win = window.to(torch.int64)[:, None]
    nn_ = n.to(torch.int64)[:, None]
    first = window_bank[0]
    in_bank = (win >= first) & (win <= window_bank[-1]) & (win % 2 == 1)
    bi = torch.clamp(torch.div(win - first, 2, rounding_mode='floor'), 0,
                     len(window_bank) - 1)[:, 0]
    timing.count('dispatch_syncs', 3)      # three uploads from the host
    coeffs = torch.from_numpy(c_np).to(dev)[bi]                  # (B, W)
    head = torch.from_numpy(h_np).to(dev)[bi]                   # (B, H, W)
    tail = torch.from_numpy(t_np).to(dev)[bi]
    pos = torch.arange(L, device=dev)[None, :]
    live = pos < nn_

    # Interior: correlation with the zero-extended live series.
    xz = torch.where(live, x, torch.zeros_like(x))
    mid = (F.pad(xz, (hmax, hmax)).unfold(1, wmax, 1)
           * coeffs[:, None, :]).sum(dim=2)
    # Edges: polynomial fits over the first and the last window.
    k = torch.arange(wmax, device=dev)[None, :]
    head_vals = torch.einsum('bhw,bw->bh', head, torch.gather(
        x, 1, torch.clamp(k, max=L - 1).expand(b, -1)))
    tail_vals = torch.einsum('bhw,bw->bh', tail, torch.gather(
        x, 1, torch.clamp(nn_ - win + k, 0, L - 1)))
    half = torch.div(win, 2, rounding_mode='floor')
    out = torch.where(pos < half, torch.gather(
        head_vals, 1, torch.clamp(pos, max=hmax - 1).expand(b, -1)), mid)
    tpos = pos - (nn_ - half)
    out = torch.where((tpos >= 0) & live, torch.gather(
        tail_vals, 1, torch.clamp(tpos, 0, hmax - 1)), out)
    return torch.where(live & in_bank, out, x)


def loess_smooth(y: torch.Tensor, n: torch.Tensor, window: torch.Tensor,
                 degree: int, max_window: int) -> torch.Tensor:
    """LOESS over uniformly spaced (B, L) series, pyloess parity.

    Window at position j: ``lo = clip(j - (window-1)//2, 0, n-window)``, the
    reference's alternate-right-first tie policy in closed form.  A flat
    series (or a NaN fit) returns the input, the reference's NaN fallback.
    """
    b, L = y.shape
    dev = y.device
    pos = torch.arange(L, device=dev)[None, :]
    nn_ = n.to(torch.int64)[:, None]
    live = pos < nn_
    w = window.to(torch.int64)[:, None]

    inf = torch.full_like(y, float('inf'))
    ymin = torch.where(live, y, inf).min(dim=1, keepdim=True).values
    ymax = torch.where(live, y, -inf).max(dim=1, keepdim=True).values
    yr = ymax - ymin
    denom_n = torch.clamp(nn_ - 1, min=1).to(torch.float32)
    n_y = _safe_div(y - ymin, yr)

    half_lo = torch.div(w - 1, 2, rounding_mode='floor')
    lo = torch.minimum(torch.clamp(pos - half_lo, min=0),
                       torch.clamp(nn_ - w, min=0))              # (B, L)
    k = torch.arange(max_window, device=dev)
    widx = lo[:, :, None] + k                                   # (B, L, W)
    in_win = k[None, None, :] < w[:, :, None]
    gidx = torch.clamp(widx, 0, L - 1)

    xw = widx.to(torch.float32) / denom_n[:, :, None]
    yw = torch.gather(n_y, 1, gidx.reshape(b, -1)).reshape(gidx.shape)
    xj = pos.to(torch.float32) / denom_n                        # (B, L)

    dist = torch.abs(xw - xj[:, :, None])
    maxd = torch.where(in_win, dist, torch.full_like(dist, -float('inf'))
                       ).max(dim=2, keepdim=True).values
    u = _safe_div(dist, maxd)
    wts = torch.where(in_win & (u <= 1.0), (1.0 - u ** 3) ** 3,
                      torch.zeros_like(u))

    powers = torch.arange(degree + 1, dtype=torch.float32, device=dev)
    xc = _safe_div(xw - xj[:, :, None], maxd)
    design = xc[..., None] ** powers                            # (B, L, W, D)
    wsum = torch.clamp(wts.sum(dim=2, keepdim=True), min=1e-20)
    ybar = (wts * yw).sum(dim=2, keepdim=True) / wsum
    yc = yw - ybar
    wd = design * wts[..., None]
    ata = torch.einsum('blwd,blwe->blde', wd, design)           # (B, L, D, D)
    atb = torch.einsum('blwd,blw->bld', wd, yc)
    beta = torch.linalg.solve_ex(ata, atb[..., None])[0][..., 0]
    resid = atb - torch.einsum('blde,ble->bld', ata, beta)
    beta = beta + torch.linalg.solve_ex(ata, resid[..., None])[0][..., 0]
    out = (beta[..., 0] + ybar[..., 0]) * yr + ymin

    bad = (yr == 0) | torch.where(live, torch.isnan(out),
                                  torch.zeros_like(live)).any(dim=1,
                                                              keepdim=True)
    out = torch.where(bad, y, out)
    return torch.where(live, out, y)


def smooth_segments(dxi: torch.Tensor, dyi: torch.Tensor,
                    seg_starts: torch.Tensor, seg_ends: torch.Tensor,
                    n_segments, *, fps: float, loess_filt: int,
                    w_secs: float, degree: int, lp_filt: int,
                    lp_cutoff: float, lp_order: int, max_len: int):
    """Low-pass + LOESS (``loess_filt``) or Savitzky-Golay every segment
    of the (T,) center series.

    Returns (dxs, dys, dxl, dyl): smoothed and low-passed series.  Segments
    shorter than 10 frames keep the low-passed series (reference
    ``loess_handler``).
    """
    dev = dxi.device
    t_out = dxi.shape[0]
    s = seg_starts.shape[0]
    live = torch.arange(s, device=dev) < n_segments
    si = seg_starts.to(torch.int64)
    cl = torch.where(live, seg_ends.to(torch.int64) - si + 1,
                     torch.ones_like(si))                        # (S,)
    w_static = int(fps * w_secs)
    if w_static % 2 == 0:
        w_static -= 1
    adj = torch.clamp(cl - 2, max=int(fps * w_secs))
    window = torch.where(adj % 2 == 0, adj - 1, adj)

    k = torch.arange(max_len, device=dev)[None, :]
    gidx = torch.clamp(si[:, None] + k, 0, t_out - 1)
    seg_mask = k < cl[:, None]
    # Both axes in one batch: rows [0, S) are x, [S, 2S) are y.
    series = torch.cat([dxi.to(torch.float32)[gidx],
                        dyi.to(torch.float32)[gidx]], dim=0)
    series = torch.where(seg_mask.repeat(2, 1), series,
                         torch.zeros_like(series))
    cl2, window2 = cl.repeat(2), window.repeat(2)
    if lp_filt:
        with timing.span('geometry.lowpass'):
            low = butter_lowpass_filter(series, cl2, lp_cutoff, fps,
                                        lp_order)
    else:
        low = series
    with timing.span('geometry.loess'):
        if loess_filt:
            sm = loess_smooth(low, cl2, window2, degree,
                              max_window=max(w_static, 5))
        else:
            sm = savgol_smooth(low, cl2, window2, degree,
                               tuple(range(5, max(w_static, 5) + 1, 2)))
    sm = torch.where((cl2 < 10)[:, None], low, sm)

    mask = (seg_mask & live[:, None]).repeat(2, 1)
    pos = gidx.reshape(-1)

    def scatter(vals):
        out = torch.zeros((t_out,), dtype=torch.float32, device=dev)
        return out.index_add_(0, pos, torch.where(
            mask[:s], vals, torch.zeros_like(vals)).reshape(-1))

    return (scatter(sm[:s]), scatter(sm[s:]), scatter(low[:s]),
            scatter(low[s:]))
