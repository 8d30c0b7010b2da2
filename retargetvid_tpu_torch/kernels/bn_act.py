"""Inference BatchNorm epilogue: BatchNorm, ReLU6 and a residual add in one
pass.

For each element of a (N, C, H, W) float32 tensor in channel ``c``:
``y = (x - mean[c]) / sqrt(var[c] + eps) * gamma[c] + beta[c]`` with the
running statistics, then ``min(max(y, 0), 6)`` where ``relu6``, then
``residual + y`` where a residual is given.  On a CUDA tensor
:func:`bn_act` launches the hand-written kernel ``csrc/bn_act.cu`` with the
plan of :func:`launch_plan`; on a CPU tensor it runs the plain PyTorch
version :func:`bn_act_reference`, the three ops it replaces
(``F.batch_norm`` in eval mode, ``torch.clamp``, ``+``).  Any other input
raises.  The kernel replaces no TPU kernel: the JAX package leaves this
epilogue to XLA's fusion with the convolution before it.

The tensor is dense, channels-last (the channel is ``i % C``) or NCHW (the
channel is ``(i // (H W)) % C``); the output has its layout, and a residual
must have it too (its strides, up to those of dimensions of size 1).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch
from torch.nn import functional as F

from retargetvid_tpu_torch.kernels.build import launch
from retargetvid_tpu_torch.utils import timing

__all__ = ["bn_act", "bn_act_reference", "launch_plan", "layout_of",
           "LaunchPlan", "MAX_CHANNELS", "MAX_ELEMENTS"]

#: CTA width, CTAs an SM holds, the most channels (their scale and shift
#: fill 48 KB of shared memory) and elements (32-bit indices); kept in
#: step with ``kThreads``, ``kCtasPerSm``, ``kMaxChannels`` and
#: ``kMaxElements`` in the CUDA source.
THREADS = 256
CTAS_PER_SM = 8
MAX_CHANNELS = 6144
MAX_ELEMENTS = 2 ** 30
#: The kernel's modes: float4 units of four channels (channels-last), of
#: one channel (NCHW), single floats (either).
NHWC_VEC, NCHW_VEC, SCALAR = 0, 1, 2
#: Shared memory of an H100 SM and what the card reserves per CTA.
SM_SHARED_BYTES = 233472
CTA_RESERVED_BYTES = 1024
#: An H100's SMs.
SMS = 132


class LaunchPlan(NamedTuple):
    """How the kernel covers ``n`` elements: ``mode``, the channel's
    period ``inner`` (1 channels-last, H*W NCHW), ``units`` of 4 or 1
    elements, ``ctas`` of :data:`THREADS` threads in a grid-stride loop,
    ``smem_bytes`` of shared memory per CTA."""
    mode: int
    inner: int
    units: int
    ctas: int
    smem_bytes: int


def layout_of(x: torch.Tensor) -> Optional[str]:
    """``'nchw'`` or ``'nhwc'`` for a dense 4-D tensor in that memory order
    (``'nchw'`` where both hold), None for anything else."""
    if x.ndim != 4:
        return None
    if x.is_contiguous():
        return 'nchw'
    if x.is_contiguous(memory_format=torch.channels_last):
        return 'nhwc'
    return None


def launch_plan(shape, layout: str, aligned: bool = True) -> LaunchPlan:
    """The kernel's plan for a (N, C, H, W) tensor in ``layout``: float4
    units where C (channels-last) or H*W (NCHW) is a multiple of 4 and
    every pointer is 16-byte ``aligned``, single floats otherwise; enough
    CTAs to fill the card's SMs once (8 an SM, fewer where the channels'
    table fills shared memory), fewer for a small tensor."""
    n, c, h, w = shape
    inner = 1 if layout == 'nhwc' else h * w
    if aligned and layout == 'nhwc' and c % 4 == 0:
        mode = NHWC_VEC
    elif aligned and layout == 'nchw' and inner % 4 == 0:
        mode = NCHW_VEC
    else:
        mode = SCALAR
    total = n * c * h * w
    units = total if mode == SCALAR else total // 4
    smem = 8 * c
    per_sm = min(CTAS_PER_SM, SM_SHARED_BYTES // (smem + CTA_RESERVED_BYTES))
    ctas = max(1, min(-(-units // THREADS), SMS * per_sm))
    return LaunchPlan(mode=mode, inner=inner, units=units, ctas=ctas,
                      smem_bytes=smem)


def bn_act_reference(x: torch.Tensor, mean, var, gamma, beta, eps: float,
                     relu6: bool = False,
                     residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version: eval-mode ``F.batch_norm``, then
    ``torch.clamp(., 0, 6)`` where ``relu6``, then ``residual +``."""
    y = F.batch_norm(x, mean, var, gamma, beta, training=False, eps=eps)
    if relu6:
        y = torch.clamp(y, 0.0, 6.0)
    return y if residual is None else residual + y


#: The library's C functions, typed once when it is loaded.
_SIGNATURES = {
    'rtv_bn_act': (
        [ctypes.c_void_p] * 7 + [ctypes.c_float] + [ctypes.c_int] * 6
        + [ctypes.c_void_p], ctypes.c_int),
}


def _check(x, mean, var, gamma, beta, residual) -> str:
    """Raise for what the kernel does not take; returns x's layout."""
    tensors = {'x': x, 'running_mean': mean, 'running_var': var,
               'weight': gamma, 'bias': beta}
    if residual is not None:
        tensors['residual'] = residual
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f'bn_act takes float32, got {name} {t.dtype}')
        if t.device != x.device:
            raise ValueError(f'bn_act: {name} on {t.device}, x on '
                             f'{x.device}')
    layout = layout_of(x)
    if layout is None:
        raise ValueError(f'bn_act takes a dense (N, C, H, W) tensor, '
                         f'channels-last or NCHW, got shape '
                         f'{tuple(x.shape)} strides {x.stride()}')
    c = x.shape[1]
    if c > MAX_CHANNELS or x.numel() > MAX_ELEMENTS:
        raise ValueError(f'bn_act takes at most {MAX_CHANNELS} channels and '
                         f'{MAX_ELEMENTS} elements, got {tuple(x.shape)}')
    for name in ('running_mean', 'running_var', 'weight', 'bias'):
        t = tensors[name]
        if t.shape != (c,) or not t.is_contiguous():
            raise ValueError(f'bn_act takes a contiguous ({c},) {name}, got '
                             f'{tuple(t.shape)}')
    if residual is not None and (residual.shape != x.shape
                                 or layout_of(residual) != layout):
        raise ValueError(f'bn_act takes a residual with the shape and '
                         f'strides of x {tuple(x.shape)} {x.stride()}, got '
                         f'{tuple(residual.shape)} {residual.stride()}')
    return layout


def _launch(x, mean, var, gamma, beta, eps, relu6, residual, layout):
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    ptrs = [x.data_ptr(), out.data_ptr()]
    if residual is not None:
        ptrs.append(residual.data_ptr())
    plan = launch_plan(tuple(x.shape), layout,
                       aligned=all(p % 16 == 0 for p in ptrs))
    launch('bn_act', _SIGNATURES, 'rtv_bn_act', x.device,
           x.data_ptr(), None if residual is None else residual.data_ptr(),
           out.data_ptr(), mean.data_ptr(), var.data_ptr(), gamma.data_ptr(),
           beta.data_ptr(), float(eps), x.numel(), x.shape[1], plan.inner,
           plan.mode, int(relu6), plan.ctas)
    timing.count('bn_act')
    return out


def bn_act(x: torch.Tensor, mean, var, gamma, beta, eps: float,
           relu6: bool = False,
           residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(N, C, H, W) float32 ``x`` and a BatchNorm's running ``mean`` and
    ``var``, ``gamma`` (weight), ``beta`` (bias) and ``eps`` -> the
    normalised tensor, ReLU6'd where ``relu6``, plus ``residual`` where
    given, in ``x``'s layout.

    CUDA tensor: the CUDA kernel (counted in the active recorder's
    ``bn_act``).  CPU tensor: the plain version.  Nothing else, on either:
    the arguments are checked first.
    """
    layout = _check(x, mean, var, gamma, beta, residual)
    if x.device.type == 'cuda':
        return _launch(x, mean, var, gamma, beta, eps, relu6, residual,
                       layout)
    if x.device.type == 'cpu':
        return bn_act_reference(x, mean, var, gamma, beta, eps, relu6,
                                residual)
    raise ValueError(f'bn_act: unsupported device {x.device}')
