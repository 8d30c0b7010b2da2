"""UNISAL's smoothing tail: nearest resize, edge pad and the rank-r
Gaussian smoothing in one launch.

For a (N, 1, h, w) float32 map, the stored factors ``kv`` (r, 1, k, 1) and
``kh`` (1, r, 1, k) of the smoothing kernel and an output size (H, W),
every output pixel is

    out[n, y, x] = sum_f sum_j kh[f, j] * sum_i kv[f, i] *
                   src[n, nr(cl(y + i - p, H)), nc(cl(x + j - p, W))]

with p = k // 2, ``nr``/``nc`` cv2 INTER_NEAREST's index rule
(``ops/resize.py:_nearest_matrix``) and ``cl`` the replicate pad's clamp.
:func:`saliency_smooth` launches the hand-written kernel
``csrc/saliency_smooth.cu`` on a CUDA tensor and raises on anything else;
:func:`smooth_reference` is the plain PyTorch version, the four ops the
kernel replaces in ``models/unisal.py`` (``resize`` nearest, ``F.pad``
replicate, the vertical then the horizontal ``F.conv2d``), and runs on the
CPU.  The kernel replaces no TPU kernel: the JAX package leaves the tail
to XLA.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch
from torch.nn import functional as F

from retargetvid_tpu_torch.kernels.build import launch
from retargetvid_tpu_torch.ops.resize import resize
from retargetvid_tpu_torch.utils import timing

__all__ = ["saliency_smooth", "smooth_reference", "flops", "launch_plan",
           "SmoothPlan", "MAX_RANK", "MAX_TAPS"]

#: Output rows of a band, the widest tile, the most factors and taps;
#: kept in step with ``kBand``, ``kMaxTile``, ``kMaxRank`` and
#: ``kMaxTaps`` in the CUDA source.
BAND = 16
MAX_TILE = 416
MAX_RANK = 16
MAX_TAPS = 63
#: Shared memory a CTA may take so that two fit on an SM (228 KB less 1 KB
#: reserved a CTA).
SMEM_BUDGET = 113 * 1024


class SmoothPlan(NamedTuple):
    """How the kernel covers an (N, 1, H, W) output: ``ctas`` CTAs, one per
    (frame, band of :data:`BAND` rows, tile of ``tile_w`` columns);
    ``n_ecols`` source columns staged per tile, at least the distinct ones
    its padded columns read; the row strides ``sv`` (the vertical pass's
    output), ``se`` (the staged source) and ``kp`` (the factor tables), in
    floats; ``smem_bytes`` of shared memory per CTA."""
    tile_w: int
    tiles_x: int
    bands: int
    ctas: int
    n_ecols: int
    sv: int
    se: int
    kp: int
    smem_bytes: int


def _bank_stride(n: int) -> int:
    """The least stride >= n that is 4 mod 8 floats: a quarter-warp's float4
    loads from 8 neighbouring rows hit 8 distinct bank groups."""
    return n + (4 - n) % 8


def launch_plan(n: int, h: int, w: int, out_h: int, out_w: int, r: int,
                k: int) -> SmoothPlan:
    """The kernel's plan for an upscale of the columns (w <= out_w): the
    widest tile of at most :data:`MAX_TILE` columns (a multiple of 8) whose
    shared memory fits :data:`SMEM_BUDGET`; at 8 columns it always does."""
    scale = w / out_w
    se = _bank_stride(BAND + k)
    kp = -(-k // 4) * 4
    tile_w = min(MAX_TILE, -(-out_w // 8) * 8)
    while True:
        vcols = tile_w + k - 1
        # The tile's padded columns read at most this many distinct source
        # columns (one more for the rounding of x * scale).
        n_ecols = min(vcols, w, math.floor((vcols - 1) * scale) + 3)
        sv = _bank_stride(tile_w + k)
        smem = 4 * (BAND * sv + n_ecols * se + 2 * r * kp + se + vcols)
        if smem <= SMEM_BUDGET or tile_w == 8:
            break
        tile_w -= 8
    tiles_x = -(-out_w // tile_w)
    bands = -(-out_h // BAND)
    return SmoothPlan(tile_w=tile_w, tiles_x=tiles_x, bands=bands,
                      ctas=n * tiles_x * bands, n_ecols=n_ecols, sv=sv,
                      se=se, kp=kp, smem_bytes=smem)


def flops(n: int, out_hw, r: int, k: int) -> int:
    """The FLOPs of the two factors' convolutions, 2 a multiply-add, as
    ``FlopCounterMode`` counts them on the plain version: the vertical sum
    at every padded column, (n, r, H, W + k - 1) outputs of k taps, then the
    horizontal one, (n, 1, H, W) outputs of r k taps.  The kernel does each
    of them as one FMA."""
    out_h, out_w = out_hw
    return 2 * n * r * out_h * k * ((out_w + k - 1) + out_w)


def smooth_reference(x: torch.Tensor, kv: torch.Tensor, kh: torch.Tensor,
                     out_hw) -> torch.Tensor:
    """Plain PyTorch version: ``resize`` nearest to ``out_hw``, ``F.pad``
    replicate by k // 2, then ``F.conv2d`` with ``kv`` and with ``kh``."""
    up = resize(x, out_hw, 'nearest', channels_last=False).to(x.dtype)
    pad = kv.shape[2] // 2
    up = F.pad(up, (pad, pad, pad, pad), mode='replicate')
    return F.conv2d(F.conv2d(up, kv), kh)


#: The library's C function, typed once when it is loaded.
_SIGNATURES = {
    'rtv_saliency_smooth': (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 12 + [ctypes.c_void_p],
        ctypes.c_int),
}


def _check(x, kv, kh, out_hw) -> None:
    """Raise for what the kernel does not take."""
    for name, t in (('x', x), ('kv', kv), ('kh', kh)):
        if t.dtype != torch.float32:
            raise TypeError(f'saliency_smooth takes float32, got {name} '
                            f'{t.dtype}')
    if not x.is_contiguous():
        raise ValueError(f'saliency_smooth takes a dense x, got strides '
                         f'{x.stride()}')
    if x.ndim != 4 or x.shape[1] != 1 or x.shape[2] < 1 or x.shape[3] < 1:
        raise ValueError(f'saliency_smooth takes an (N, 1, h, w) map, got '
                         f'{tuple(x.shape)}')
    if x.shape[2] * x.shape[3] >= 2 ** 31:
        raise ValueError(f'saliency_smooth takes frames of fewer than 2^31 '
                         f'pixels, got {tuple(x.shape)}')
    r, k = (kv.shape[0], kv.shape[2]) if kv.ndim == 4 else (0, 0)
    if (tuple(kv.shape) != (r, 1, k, 1) or tuple(kh.shape) != (1, r, 1, k)
            or not 1 <= r <= MAX_RANK or not 1 <= k <= MAX_TAPS
            or k % 2 == 0):
        raise ValueError(f'saliency_smooth takes factors (r, 1, k, 1) and '
                         f'(1, r, 1, k), r <= {MAX_RANK}, odd k <= '
                         f'{MAX_TAPS}; got {tuple(kv.shape)} and '
                         f'{tuple(kh.shape)}')
    if len(out_hw) != 2 or min(out_hw) < 0:
        raise ValueError(f'saliency_smooth: output size {out_hw}')
    if x.shape[3] > out_hw[1]:
        raise ValueError(f'saliency_smooth upscales the columns: the map\'s '
                         f'width {x.shape[3]} is over the output\'s '
                         f'{out_hw[1]}')
    for name, t in (('kv', kv), ('kh', kh)):
        if t.device != x.device:
            raise ValueError(f'saliency_smooth: {name} on {t.device}, x on '
                             f'{x.device}')
    if x.device.type != 'cuda':
        raise ValueError(f'saliency_smooth runs on a CUDA device, got '
                         f'{x.device}; smooth_reference is the plain version')


def saliency_smooth(x: torch.Tensor, kv: torch.Tensor, kh: torch.Tensor,
                    out_hw) -> torch.Tensor:
    """Dense (N, 1, h, w) float32 CUDA ``x`` and the smoothing's factors
    ``kv`` (r, 1, k, 1) and ``kh`` (1, r, 1, k) -> the smoothed (N, 1, H,
    W) map at ``out_hw`` = (H, W), w <= W, in one launch of the CUDA kernel
    (counted in the active recorder's ``saliency_smooth``).  Anything else
    raises."""
    _check(x, kv, kh, out_hw)
    n, _, h, w = x.shape
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    out = torch.empty((n, 1, out_h, out_w), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    kv, kh = kv.contiguous(), kh.contiguous()
    r, k = kv.shape[0], kv.shape[2]
    plan = launch_plan(n, h, w, out_h, out_w, r, k)
    launch('saliency_smooth', _SIGNATURES, 'rtv_saliency_smooth', x.device,
           x.data_ptr(), kv.data_ptr(), kh.data_ptr(), out.data_ptr(), n, h,
           w, out_h, out_w, r, k, plan.tile_w, plan.n_ecols, plan.sv,
           plan.se, plan.kp)
    timing.count('saliency_smooth')
    return out
