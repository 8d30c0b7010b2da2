"""Bytes a kernel has to move, and the card's published bandwidth.

Each input byte is counted read once and each output byte written once, at
the live sizes of the call, whatever the kernel reads again or pads.
"""

from __future__ import annotations

#: NVIDIA H100 SXM HBM3 bandwidth (data sheet), bytes/s.
HBM_BYTES_PER_S = 3.35e12


def postprocess_bytes(frames: int, h: int, w: int) -> int:
    """The saliency postprocess: float32 log-probabilities in, uint8 maps
    out."""
    return frames * h * w * (4 + 1)
