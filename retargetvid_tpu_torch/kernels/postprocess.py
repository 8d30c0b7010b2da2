"""Saliency postprocess: UNISAL log-probabilities -> uint8 maps.

For each frame of a (T, H, W) float32 stack: ``p = exp(x)``,
``m = max(p)``, ``out = floor((p / m) * 255)`` (0 where ``m == 0``), as
uint8.  On a CUDA tensor :func:`saliency_postprocess` launches the
hand-written kernel ``csrc/saliency_postprocess.cu`` (which replaces the
Pallas TPU kernel ``retargetvid_tpu/ops/pallas_kernels.py:
saliency_postprocess``); on a CPU tensor it runs the plain PyTorch version
:func:`saliency_postprocess_reference`.  Any other input raises.
"""

from __future__ import annotations

import ctypes

import torch

from retargetvid_tpu_torch.kernels.build import check_launch, load_library

__all__ = ["saliency_postprocess", "saliency_postprocess_reference"]


def saliency_postprocess_reference(logp: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``(where(m > 0, p / m, p) * 255)`` as uint8."""
    p = torch.exp(logp.to(torch.float32))
    m = torch.amax(p, dim=(1, 2), keepdim=True)
    return (torch.where(m > 0, p / m, p) * 255.0).to(torch.uint8)


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
    out = torch.empty((t, h, w), dtype=torch.uint8, device=logp.device)
    lib = load_library('saliency_postprocess')
    fn = lib.rtv_saliency_postprocess
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(logp.device):
        stream = torch.cuda.current_stream(logp.device).cuda_stream
        rc = fn(logp.data_ptr(), out.data_ptr(), t, h * w, stream)
    check_launch(lib, 'saliency_postprocess', rc)
    saliency_postprocess.launches += 1
    return out


def saliency_postprocess(logp: torch.Tensor) -> torch.Tensor:
    """(T, H, W) float32 log-probabilities -> (T, H, W) uint8 maps.

    CUDA tensor: the CUDA kernel (counted in ``saliency_postprocess.
    launches``).  CPU tensor: the plain version.  Nothing else.
    """
    if logp.device.type == 'cuda':
        return _launch(logp)
    if logp.device.type == 'cpu':
        return saliency_postprocess_reference(logp)
    raise ValueError(f'saliency_postprocess: unsupported device '
                     f'{logp.device}')


#: Kernel launches since the count was last set to 0.
saliency_postprocess.launches = 0
