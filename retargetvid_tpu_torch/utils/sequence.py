"""Sequence post-processing on the tensor's device.

Port of ``retargetvid_tpu/utils/sequence.py:smooth_sequence`` (reference
``unisal/utils.py:201-217``): a temporal median over a window of frames.
The result equals numpy's ``np.median`` bit for bit: a window of odd size
takes its middle value, one of even size (at the ends of the clip) the
float32 mean ``(a + b) / 2`` of its two middle values, where
``torch.median`` would return the lower one.
"""

from __future__ import annotations

import torch

__all__ = ["smooth_sequence"]

#: Window elements sorted at once (frames x pixels x window) in the
#: interior, bounding the memory of the sort.
_BLOCK_ELEMS = 1 << 26


def _window_median(win: torch.Tensor) -> torch.Tensor:
    """numpy's median over dim 0 of an (n, P) window."""
    n = win.shape[0]
    s = torch.sort(win, dim=0).values
    if n % 2:
        return s[n // 2]
    return (s[n // 2 - 1] + s[n // 2]) / 2


def smooth_sequence(seq: torch.Tensor, method: str) -> torch.Tensor:
    """Median-smooth a (1, T, 1, H, W)- or (T, ...)-shaped sequence along
    T; ``method`` is ``'med<k>'`` (window ``2 * (k // 2) + 1``, cut at the
    ends of the clip)."""
    if not method.startswith('med'):
        raise NotImplementedError(method)
    ks2 = int(method[3:]) // 2
    shape = seq.shape
    flat = seq.reshape(shape[1] if seq.ndim == 5 else shape[0], -1)
    t, n_px = flat.shape
    out = torch.empty_like(flat)
    # Interior frames: every window is full, so they share one sliding
    # view; its size is odd, so the median is one of its values.
    k = 2 * ks2 + 1
    first, stop = ks2, t - ks2
    if stop > first:
        windows = flat.unfold(0, k, 1)              # (t - k + 1, P, k)
        block = max(1, _BLOCK_ELEMS // (n_px * k))
        for s in range(first, stop, block):
            e = min(stop, s + block)
            out[s:e] = torch.median(windows[s - ks2:e - ks2], dim=-1).values
    for i in [*range(min(first, t)), *range(max(stop, first), t)]:
        out[i] = _window_median(flat[max(0, i - ks2):min(t, i + ks2 + 1)])
    return out.reshape(shape)
