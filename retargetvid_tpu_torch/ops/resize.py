"""Image resizing with separable interpolation matrices.

The resamplers of the reference pipeline (cv2 ``INTER_LINEAR`` /
``INTER_CUBIC`` / ``INTER_NEAREST`` and PIL ``LANCZOS``) are separable, so a
resize is two products with per-axis interpolation matrices built once on
the host:

    out[H', W'] = A_h[H', H] @ img[H, W] @ A_w[W, W']

The matrix builders are the JAX package's, so both packages sample the
same source pixels with the same weights.  Each product is applied as a
sum over the matrix's few nonzero taps per row (see ``_resize_axis``).
``F.interpolate`` does not reproduce these matrices (cv2's edge clamping,
PIL's support stretching).
"""

from __future__ import annotations

import decimal
import functools

import numpy as np
import torch

from retargetvid_tpu_torch.utils import timing

__all__ = ["resize", "resize_by_factor", "apply_taps", "factor_dst_size",
           "round_half_up", "RESIZE_TYPE_TO_METHOD"]

#: The crop parameters' ``resize_type`` codes as method names (reference
#: ``smartVidCrop.py:141-143``).
RESIZE_TYPE_TO_METHOD = {1: 'linear', 2: 'cubic', 3: 'nearest'}


def round_half_up(x: torch.Tensor) -> torch.Tensor:
    """uint8 quantization with cv2/PIL semantics: ``floor(x + 0.5)``.

    Not ``torch.round``, which rounds half to even and flips about half of
    the exact-.5 averages a power-of-two downscale produces.
    """
    return torch.floor(x + 0.5)


def _linear_matrix(src: int, dst: int, scale=None) -> np.ndarray:
    """cv2 INTER_LINEAR: half-pixel centers, 2-tap, edge clamped."""
    a = np.zeros((dst, src), dtype=np.float32)
    if src == 1:
        a[:, 0] = 1.0
        return a
    scale = src / dst if scale is None else float(scale)
    for d in range(dst):
        sx = (d + 0.5) * scale - 0.5
        x0 = int(np.floor(sx))
        frac = sx - x0
        x0c = min(max(x0, 0), src - 1)
        x1c = min(max(x0 + 1, 0), src - 1)
        a[d, x0c] += 1.0 - frac
        a[d, x1c] += frac
    return a


def _nearest_matrix(src: int, dst: int, scale=None) -> np.ndarray:
    """cv2 INTER_NEAREST: sx = floor(dx * scale)."""
    a = np.zeros((dst, src), dtype=np.float32)
    scale = src / dst if scale is None else float(scale)
    idx = np.minimum(np.floor(np.arange(dst) * scale).astype(np.int64),
                     src - 1)
    a[np.arange(dst), idx] = 1.0
    return a


def _cubic_kernel(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Keys cubic kernel with cv2's a=-0.75."""
    x = np.abs(x)
    return np.where(
        x <= 1, (a + 2) * x**3 - (a + 3) * x**2 + 1,
        np.where(x < 2, a * x**3 - 5 * a * x**2 + 8 * a * x - 4 * a, 0.0))


def _cubic_matrix(src: int, dst: int, scale=None) -> np.ndarray:
    """cv2 INTER_CUBIC: half-pixel centers, 4-tap Keys kernel, edge clamped."""
    a = np.zeros((dst, src), dtype=np.float32)
    if src == 1:
        a[:, 0] = 1.0
        return a
    scale = src / dst if scale is None else float(scale)
    for d in range(dst):
        sx = (d + 0.5) * scale - 0.5
        x0 = int(np.floor(sx))
        for t in range(-1, 3):
            w = _cubic_kernel(np.array(sx - (x0 + t)))
            xc = min(max(x0 + t, 0), src - 1)
            a[d, xc] += float(w)
    return a


def _lanczos_kernel(x: np.ndarray, support: float = 3.0) -> np.ndarray:
    x = np.asarray(x, dtype=np.float64)
    out = np.sinc(x) * np.sinc(x / support)
    return np.where(np.abs(x) < support, out, 0.0)


def _lanczos_matrix(src: int, dst: int, scale=None) -> np.ndarray:
    """PIL LANCZOS (support 3): kernel stretched by the scale on downsize,
    weights normalized per output pixel."""
    a = np.zeros((dst, src), dtype=np.float64)
    scale = src / dst if scale is None else float(scale)
    filterscale = max(scale, 1.0)
    support = 3.0 * filterscale
    for d in range(dst):
        center = (d + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        hi = min(int(center + support + 0.5), src)
        xs = np.arange(lo, hi)
        w = _lanczos_kernel((xs + 0.5 - center) / filterscale)
        s = w.sum()
        if s != 0:
            w = w / s
        a[d, lo:hi] = w
    return a.astype(np.float32)


_BUILDERS = {
    'linear': _linear_matrix,
    'nearest': _nearest_matrix,
    'cubic': _cubic_matrix,
    'lanczos': _lanczos_matrix,
}


@functools.lru_cache(maxsize=256)
def _resize_matrix_np(src: int, dst: int, method: str,
                      scale=None) -> np.ndarray:
    if method not in _BUILDERS:
        raise ValueError(f'unknown resize method {method!r}')
    return _BUILDERS[method](src, dst, scale)


@functools.lru_cache(maxsize=256)
def _taps_np(src: int, dst: int, method: str, scale=None):
    """The matrix's nonzeros per output row, ascending source index, padded
    with weight-0 taps: (idx (K, dst) int64, w (K, dst) float32)."""
    a = _resize_matrix_np(src, dst, method, scale)
    nz = [np.nonzero(row)[0] for row in a]
    k = max(1, max(len(n) for n in nz))
    idx = np.zeros((k, dst), np.int64)
    w = np.zeros((k, dst), np.float32)
    for d, n in enumerate(nz):
        idx[:len(n), d] = n
        w[:len(n), d] = a[d, n]
    return idx, w


def factor_dst_size(h: int, w: int, factor: float):
    """Output dims of ``cv2.resize(img, None, fx=1/factor, fy=1/factor)``:
    cvRound (round-half-to-even) of src/factor."""
    return (_cv_round(h / factor), _cv_round(w / factor))


def _cv_round(v: float) -> int:
    return int(decimal.Decimal(v).quantize(
        0, rounding=decimal.ROUND_HALF_EVEN))


def _resize_axis(x: torch.Tensor, dim: int, dst: int, method: str,
                 scale=None) -> torch.Tensor:
    """One axis of the separable product, as a sum over the matrix's taps.

    Each output is ``w_0*x_0 + w_1*x_1 + ...`` summed in ascending source
    order, every product rounded to float32 before it is added; the card
    computes it the same way every time.  It is what XLA:CPU computes for
    both products of the 360x640 -> 27x48 ingest (equal in uint8) and for
    the height product of 360x640 -> 140x250.  For that shape's width
    product XLA:CPU fuses the second tap, ``fma(x1, w1, round(x0*w0))``, so
    0.03% of its uint8 values sit on the other side of a .5 boundary
    (``tests/test_torch_resize.py`` pins both forms).  XLA's choice follows
    the shape, so no one rounding rule matches it everywhere; a BLAS matmul
    fuses too and matches neither.
    """
    idx_np, w_np = _taps_np(int(x.shape[dim]), dst, method, scale)
    return apply_taps(x, dim, idx_np, w_np)


def apply_taps(x: torch.Tensor, dim: int, idx_np: np.ndarray,
               w_np: np.ndarray) -> torch.Tensor:
    """``sum_k x[idx[k]] * w[k]`` along ``dim`` in ascending k, each
    product rounded to float32 before it is added (``_resize_axis``'s
    arithmetic); ``idx``/``w`` (K, dst) index ``x``'s own positions."""
    timing.count('dispatch_syncs', 2)      # idx and w, from the host
    idx = torch.from_numpy(np.ascontiguousarray(idx_np)).to(x.device)
    dst = idx.shape[1]
    shape = [1] * x.ndim
    shape[dim] = dst
    w = torch.from_numpy(np.ascontiguousarray(w_np)).to(x.device)
    out = None
    for k in range(idx.shape[0]):
        # Gather before the (exact) float32 conversion: a uint8 clip is
        # never widened whole.
        term = torch.index_select(x, dim, idx[k]).to(torch.float32) \
            * w[k].view(shape)
        out = term if out is None else out + term
    return out


def _resize_hw(x, h_out, w_out, method, channels_last, scale=None):
    hd, wd = (-3, -2) if channels_last else (-2, -1)
    x = _resize_axis(x, x.ndim + hd, h_out, method, scale)
    return _resize_axis(x, x.ndim + wd, w_out, method, scale)


def resize(img: torch.Tensor, out_hw, method: str = 'linear', *,
           channels_last: bool) -> torch.Tensor:
    """Separable resize of ``img`` to ``out_hw``; float32 result.

    ``channels_last`` says whether ``img`` is (..., H, W, C) or (..., H, W).
    The JAX package guesses it from a trailing axis <= 4; here the caller
    states it.
    """
    return _resize_hw(img, int(out_hw[0]), int(out_hw[1]), method,
                      channels_last)


def resize_by_factor(img: torch.Tensor, factor: float,
                     method: str = 'linear', *,
                     channels_last: bool) -> torch.Tensor:
    """``cv2.resize(img, None, fx=1/factor, fy=1/factor)``: dst dims are
    cvRound(src/factor) and coordinates map with exactly ``factor``."""
    hd, wd = (-3, -2) if channels_last else (-2, -1)
    h_out, w_out = factor_dst_size(img.shape[hd], img.shape[wd], factor)
    return _resize_hw(img, h_out, w_out, method, channels_last,
                      scale=float(factor))
