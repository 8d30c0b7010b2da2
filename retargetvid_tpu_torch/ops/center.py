"""Focus-center extraction (reference ``sc_find_center_of_mass``).

Port of ``retargetvid_tpu/ops/center.py:center_of_mass`` with ``km=True``:
a one-cluster KMeans over the nonzero pixels converges to their mean
coordinate after one update, so the center is a masked mean, batched over
frames.  The sums are of integer coordinates below 2**24 and so exact in
float32 in any order.
"""

from __future__ import annotations

import torch

__all__ = ["center_of_mass"]


def center_of_mass(smaps: torch.Tensor, *, km: bool = True,
                   factor: float = 1.0):
    """Per-frame focus centers ``(x, y, valid)`` of a (T, H, W) volume."""
    if not km or factor != 1.0:
        raise NotImplementedError(
            'only the km=True, resize_factor=1 center of mass is ported')
    t, h, w = smaps.shape
    mask = (smaps > 0).to(torch.float32)
    n = torch.sum(mask, dim=(1, 2))
    rows = torch.arange(h, dtype=torch.float32, device=smaps.device)
    cols = torch.arange(w, dtype=torch.float32, device=smaps.device)
    sum_r = torch.sum(mask * rows[:, None], dim=(1, 2))
    sum_c = torch.sum(mask * cols[None, :], dim=(1, 2))
    safe_n = torch.clamp(n, min=1.0)
    return sum_c / safe_n, sum_r / safe_n, n > 0
