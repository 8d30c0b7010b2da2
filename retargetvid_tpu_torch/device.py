"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU; a missing GPU is an error, never a fallback.

    Pass ``device="cpu"`` explicitly to run the plain PyTorch versions on the
    host (the parity tests do).
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                'no CUDA device available; pass device="cpu" to run on the '
                'host explicitly')
        return torch.device('cuda')
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f'{device} requested but CUDA is not available')
    return device
