"""Shot-transition scoring utilities (host numpy/scipy).

Port of ``retargetvid_tpu/models/shot_scoring.py``, the reusable surface of
the reference's standalone shot-detector experiment
(``3rd_party_libs/transnetv1/post_process.py``), pure signal functions over
per-frame transition probabilities:

- ``mov_avg`` (``post_process.py:44-68``): edge-aware moving average, the
  first/last half-windows replaced by the CONSTANT mean of that edge
  region (the reference loop's evident intent; its own code raises).
- ``smooth`` (``:70-73``): plain box convolution, 'same' mode.
- ``find_extremas`` (``:75-103``): local maxima via ``argrelextrema`` plus
  the minimum BETWEEN consecutive maxima (not symmetric local minima), both
  shifted +1, as the reference does.
- ``process_sd_x`` (``:105-123``): transition score per maximum =
  |max - previous min| + |max - next min|, clipped at 1.0.
- ``trans_to_boundaries`` / ``trans_to_list`` (``:125-143``): thresholded
  scores to shot spans / cut indices (spans start at prev+1, as the
  reference does).

The script's Keras model code is not ported (its weights and data are not
in the repository).  No serving path imports this module.
"""

from __future__ import annotations

import numpy as np
from scipy.signal import argrelextrema

__all__ = ["mov_avg", "smooth", "find_extremas", "process_sd_x",
           "trans_to_boundaries", "trans_to_list"]


def mov_avg(x, window: int = 3) -> np.ndarray:
    """Edge-aware moving average, (N, 1) float output like the reference."""
    x = np.asarray(x, dtype=float)
    n = len(x)
    half = (window - 1) // 2
    y = np.zeros((n, 1), dtype=float)
    lead = x[:half].mean() if half > 0 else 0.0
    tail = x[n - half:].mean() if half > 0 else 0.0
    for i in range(n):
        if i < half:
            y[i] = lead
        elif i >= n - half:
            y[i] = tail
        else:
            y[i] = x[i - half:i + half + 1].mean()
    return y


def smooth(x, window: int = 3) -> np.ndarray:
    """Box smoothing, numpy 'same' convolution (reference ``smooth``)."""
    w = np.ones(window, 'd')
    return np.convolve(w / w.sum(), np.asarray(x, dtype=float), mode='same')


def find_extremas(x, order: int = 3):
    """(minima, maxima) indices, both +1-shifted (reference quirk).

    Maxima are standard ``argrelextrema`` greater-comparisons; "minima" are
    the argmin BEFORE the first maximum and between each consecutive pair
    of maxima (NOT symmetric local minima).
    """
    x = np.asarray(x, dtype=float)
    lmax = argrelextrema(x, np.greater, order=order)[0]
    lmin = [int(np.argmin(x[:lmax[0]]))]
    for i in range(len(lmax) - 1):
        span = x[lmax[i] + 1:lmax[i + 1]]
        lmin.append(lmax[i] + 1 + int(np.argmin(span)))
    return np.array(lmin) + 1, lmax + 1


def process_sd_x(x, window: int = 3, order: int = 3, verbose: bool = False):
    """Transition scores: per maximum, prominence against flanking minima.

    Returns (scores, smoothed, mins_marks, maxs_marks) like the reference;
    the FIRST maximum scores 0 (the reference loop starts at k=1).
    """
    x = np.asarray(x, dtype=float)
    n = len(x)
    xs = smooth(x, window=window)
    mins, maxs = find_extremas(xs, order=order)
    y = np.zeros(n, dtype=float)
    for k in range(1, len(maxs)):
        score = (abs(xs[maxs[k]] - xs[mins[k - 1]]) +
                 abs(xs[maxs[k]] - xs[mins[k]]))
        y[maxs[k]] = min(score, 1.0)
    maxs_t = np.zeros(n, dtype=float)
    maxs_t[maxs] = xs[maxs]
    mins_t = np.zeros(n, dtype=float)
    mins_t[mins] = xs[mins]
    return y, xs, mins_t, maxs_t


def trans_to_boundaries(y, t: float = 0.40) -> list:
    """Shot [start, end] spans from thresholded transition scores.

    Spans start at the previous boundary + 1 (reference quirk: the first
    span starts at 1, and the final span ends at ``len(y)``).
    """
    bounds = []
    prev = 0
    for i, v in enumerate(np.asarray(y, dtype=float)):
        if v >= t:
            bounds.append([prev + 1, i])
            prev = i
    bounds.append([prev + 1, len(y)])
    return bounds


def trans_to_list(y, t: float = 0.40) -> list:
    """Cut indices from thresholded scores, terminated by ``len(y)``."""
    out = [i for i, v in enumerate(np.asarray(y, dtype=float)) if v >= t]
    out.append(len(y))
    return out
