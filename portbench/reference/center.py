"""Focus-center extraction (reference ``sc_find_center_of_mass``).

Frozen copy of the port's version of ``retargetvid_tpu/ops/center.py:center_of_mass``.  With ``km=True``
a one-cluster KMeans over the nonzero pixels of the nearest-downscaled map
converges to their mean coordinate after one update, so the center is a
masked mean, batched over frames and scaled back by ``factor``.  The sums
are of integer coordinates below 2**24 and so exact in float32 in any
order.  With ``km=False`` the center is the first maximum pixel
(reference ``smartVidCrop.py:1164-1178``).
"""

from __future__ import annotations

import torch

from portbench.reference.resize import resize_by_factor

__all__ = ["center_of_mass"]


def center_of_mass(smaps: torch.Tensor, *, km: bool = True,
                   factor: float = 1.0):
    """Per-frame focus centers ``(x, y, valid)`` of a (T, H, W) volume, in
    the volume's coordinates; ``valid`` is False for an empty map."""
    smaps = smaps.to(torch.float32)
    t, h, w = smaps.shape
    if not km:
        flat = smaps.reshape(t, -1)
        max_val = torch.amax(flat, dim=1)
        idx = torch.argmax(flat, dim=1)             # the first maximum
        y = torch.div(idx, w, rounding_mode='floor').to(torch.float32)
        x = (idx % w).to(torch.float32)
        return x, y, max_val > 0

    if factor != 1.0:
        # cv2 fx= form: dst dims cvRound(src/factor), coordinates map with
        # exactly ``factor`` (reference smartVidCrop.py:1186).
        smaps = resize_by_factor(smaps, factor, 'nearest',
                                 channels_last=False)
    mask = (smaps > 0).to(torch.float32)
    n = torch.sum(mask, dim=(1, 2))
    rows = torch.arange(mask.shape[1], dtype=torch.float32,
                        device=smaps.device)
    cols = torch.arange(mask.shape[2], dtype=torch.float32,
                        device=smaps.device)
    sum_r = torch.sum(mask * rows[:, None], dim=(1, 2))
    sum_c = torch.sum(mask * cols[None, :], dim=(1, 2))
    safe_n = torch.clamp(n, min=1.0)
    x, y = sum_c / safe_n, sum_r / safe_n
    if factor != 1.0:
        x, y = x * factor, y * factor
    return x, y, n > 0
