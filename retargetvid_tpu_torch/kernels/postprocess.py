"""Saliency postprocess: UNISAL log-probabilities -> uint8 maps.

For each frame of a (T, H, W) float32 stack: ``p = exp(x)``,
``m = max(p)``, ``out = floor((p / m) * 255)`` (0 where ``m == 0``), as
uint8.  On a CUDA tensor :func:`saliency_postprocess` launches the
hand-written kernel ``csrc/saliency_postprocess.cu`` (which replaces the
Pallas TPU kernel ``retargetvid_tpu/ops/pallas_kernels.py:
saliency_postprocess``) with the plan of :func:`launch_plan`; on a CPU
tensor it runs the plain PyTorch version
:func:`saliency_postprocess_reference`.  Any other input raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from retargetvid_tpu_torch.kernels.build import launch

__all__ = ["saliency_postprocess", "saliency_postprocess_reference",
           "launch_plan", "LaunchPlan"]

#: CTA width and the floats each thread holds in registers; kept in step
#: with ``kThreads`` and ``kFloatsPerThread`` in the CUDA source.
THREADS = 256
FLOATS_PER_THREAD = 36
#: Floats of a frame one CTA keeps on chip.
ON_CHIP_FLOATS = THREADS * FLOATS_PER_THREAD
#: The largest portable thread-block cluster.
MAX_CLUSTER = 8
#: Enough CTAs for two on each of an H100's 132 SMs.
TARGET_CTAS = 2 * 132
#: Static shared memory of a CTA: one float per warp and the CTA's max.
SMEM_BYTES = 4 * (THREADS // 32 + 1)


class LaunchPlan(NamedTuple):
    """How the kernel covers a (T, hw) stack: ``cluster`` CTAs per frame,
    CTA ``r`` over elements ``[r * slice, (r + 1) * slice)`` of its frame
    (clipped to ``hw``)."""
    cluster: int
    slice: int
    vec: bool              # float4 loads / uchar4 stores (hw % 4 == 0)
    smem_bytes: int
    on_chip: bool          # every slice fits in its CTA's registers
    ctas: int

    def cta_bounds(self, hw: int) -> Tuple[Tuple[int, int], ...]:
        """Each CTA's [lo, hi) within a frame, as the kernel computes it."""
        return tuple((min(r * self.slice, hw), min((r + 1) * self.slice, hw))
                     for r in range(self.cluster))


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=64)
def launch_plan(t: int, hw: int) -> LaunchPlan:
    """The kernel's launch plan for ``t`` frames of ``hw`` pixels.

    Frames are split into clusters of 2, 4 or 8 CTAs until the card has two
    CTAs per SM, as long as each CTA keeps at least one float4 per thread;
    a frame larger than its cluster holds on chip takes a larger cluster,
    up to 8, and beyond that its overflow is re-read in the scale pass.
    Slices are multiples of 4 elements, so each starts 16-byte aligned.
    """
    c = 1
    while (c < MAX_CLUSTER and t * c < TARGET_CTAS
           and _ceil_div(hw, 2 * c) >= THREADS * 4):
        c *= 2
    while c < MAX_CLUSTER and _ceil_div(hw, c) > ON_CHIP_FLOATS:
        c *= 2
    slice_ = _ceil_div(_ceil_div(hw, c), 4) * 4
    return LaunchPlan(cluster=c, slice=slice_, vec=hw % 4 == 0,
                      smem_bytes=SMEM_BYTES,
                      on_chip=slice_ <= ON_CHIP_FLOATS, ctas=t * c)


def saliency_postprocess_reference(logp: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``(where(m > 0, p / m, p) * 255)`` as uint8."""
    p = torch.exp(logp.to(torch.float32))
    m = torch.amax(p, dim=(1, 2), keepdim=True)
    return (torch.where(m > 0, p / m, p) * 255.0).to(torch.uint8)


#: The library's C functions, typed once when it is loaded.
_SIGNATURES = {
    'rtv_saliency_postprocess': (
        [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 5
        + [ctypes.c_void_p], ctypes.c_int),
}


def _launch(logp: torch.Tensor) -> torch.Tensor:
    if logp.dtype != torch.float32:
        raise TypeError(f'saliency_postprocess takes float32, got '
                        f'{logp.dtype}')
    if logp.ndim != 3:
        raise ValueError(f'saliency_postprocess takes (T, H, W), got '
                         f'{tuple(logp.shape)}')
    if not logp.is_contiguous():
        raise ValueError('saliency_postprocess takes a contiguous tensor')
    t, h, w = logp.shape
    plan = launch_plan(t, h * w)
    out = torch.empty((t, h, w), dtype=torch.uint8, device=logp.device)
    # float4 loads need a 16-byte aligned input (a view may start anywhere).
    vec = plan.vec and logp.data_ptr() % 16 == 0
    launch('saliency_postprocess', _SIGNATURES, 'rtv_saliency_postprocess',
           logp.device, logp.data_ptr(), out.data_ptr(), t, h * w,
           plan.cluster, plan.slice, int(vec))
    return out


def saliency_postprocess(logp: torch.Tensor) -> torch.Tensor:
    """(T, H, W) float32 log-probabilities -> (T, H, W) uint8 maps.

    CUDA tensor: the CUDA kernel.  CPU tensor: the plain version.  Nothing
    else.
    """
    if logp.device.type == 'cuda':
        return _launch(logp)
    if logp.device.type == 'cpu':
        return saliency_postprocess_reference(logp)
    raise ValueError(f'saliency_postprocess: unsupported device '
                     f'{logp.device}')
