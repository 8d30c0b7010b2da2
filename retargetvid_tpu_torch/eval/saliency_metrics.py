"""Saliency evaluation metrics: AUC-Judd, shuffled AUC, SIM (numpy).

The port's own copy of ``retargetvid_tpu/eval/saliency_metrics.py``
(reference ``unisal/salience_metrics.py:10-103``), used by
``train/trainer.py:Trainer.score_model`` and ``run_inference``.  AUC
variants are threshold sweeps over fixation points; SIM is the histogram
intersection of the sum-normalized maps.
"""

from __future__ import annotations

import numpy as np

__all__ = ["auc_judd", "auc_shuffled", "sim", "normalize_map"]

#: ``np.trapezoid`` (numpy >= 2.0), else its older name.
_trapezoid = getattr(np, 'trapezoid', None) or np.trapz


def normalize_map(s: np.ndarray) -> np.ndarray:
    """Min-max normalize to [0, 1]."""
    s = np.asarray(s, np.float64)
    lo, hi = s.min(), s.max()
    if hi > lo:
        return (s - lo) / (hi - lo)
    return np.zeros_like(s)


def auc_judd(sal_map: np.ndarray, fix_map: np.ndarray) -> float:
    """AUC-Judd: thresholds at each fixation's saliency value."""
    s = normalize_map(sal_map).ravel()
    f = np.asarray(fix_map).ravel() > 0.5
    if not f.any():
        return float('nan')
    s_fix = np.sort(s[f])[::-1]
    n_fix = len(s_fix)
    n_pix = len(s)
    tp = [0.0]
    fp = [0.0]
    for i, thresh in enumerate(s_fix):
        above = float(np.sum(s >= thresh))
        tp.append((i + 1) / n_fix)
        fp.append((above - (i + 1)) / (n_pix - n_fix))
    tp.append(1.0)
    fp.append(1.0)
    return float(_trapezoid(tp, fp))


def auc_shuffled(sal_map: np.ndarray, fix_map: np.ndarray,
                 other_map: np.ndarray, n_splits: int = 100,
                 step_size: float = 0.1, rng=None) -> float:
    """Shuffled AUC: negatives sampled from other images' fixation
    locations."""
    rng = rng or np.random.default_rng(0)
    s = normalize_map(sal_map).ravel()
    f = np.asarray(fix_map).ravel() > 0.5
    o = np.asarray(other_map).ravel() > 0.5
    if not f.any() or not o.any():
        return float('nan')
    s_fix = s[f]
    n_fix = len(s_fix)
    other_idx = np.flatnonzero(o)
    aucs = []
    for _ in range(n_splits):
        take = rng.choice(other_idx, size=min(n_fix, len(other_idx)),
                          replace=len(other_idx) < n_fix)
        s_other = s[take]
        thresholds = np.arange(0, 1 + step_size, step_size)[::-1]
        tp = [0.0]
        fp = [0.0]
        for t in thresholds:
            tp.append(float(np.mean(s_fix >= t)))
            fp.append(float(np.mean(s_other >= t)))
        tp.append(1.0)
        fp.append(1.0)
        aucs.append(_trapezoid(tp, fp))
    return float(np.mean(aucs))


def sim(sal_map: np.ndarray, gt_map: np.ndarray) -> float:
    """Similarity: histogram intersection of sum-normalized maps."""
    s = np.asarray(sal_map, np.float64)
    g = np.asarray(gt_map, np.float64)
    if s.sum() <= 0 or g.sum() <= 0:
        return float('nan')
    s = s / s.sum()
    g = g / g.sum()
    return float(np.minimum(s, g).sum())
