"""Saliency training losses (PyTorch).

Port of ``retargetvid_tpu/train/losses.py`` (reference
``unisal/utils.py:139-184``).  All losses take (B, T, H, W, 1) sequences:

- ``kld_loss(pred_log, target)``: KL(target || exp(pred_log)) summed over
  the map per (B, T), with 0*log(0) = 0 (``torch.xlogy``);
- ``nss(pred, fixations)``: mean of the standardized prediction over
  fixation pixels, standard deviation with ddof=1 floored at 1e-12; empty
  fixation maps score 1.0 like the reference;
- ``corr_coeff(pred, target)``: Pearson correlation per (B, T).

The composite training loss is ``1*kld - 0.1*nss - 0.1*cc``
(``unisal/train.py:104-105, 410-423``) with nss/cc applied to exp(pred).

Under mesh training with the rows split over sp (``parallel/shard.py``)
every sum over the map reduces over sp: the means and the NSS deviation
(two passes, as here) with their gradients reduced too, as every rank
applies them to its own pixels; the per-(B, T) results with their
gradients passed unchanged, as every rank then holds the same value.
"""

from __future__ import annotations

import torch

from retargetvid_tpu_torch.parallel import shard
from retargetvid_tpu_torch.parallel.collectives import sum_over, \
    sum_replicated

__all__ = ["kld_loss", "nss", "corr_coeff", "loss_sequences"]


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], x.shape[1], -1)


def _split():
    sharded = shard.current()
    return sharded if sharded is not None and sharded.split else None


def _map_sums(*vals, stat: bool) -> list:
    """Each (B, T, N) value summed over the map: this rank's pixels, then
    over sp in one all-reduce (``stat``: gradients reduced as well)."""
    sums = torch.stack([v.sum(dim=-1) for v in vals], dim=-1)
    sharded = _split()
    if sharded is not None:
        sums = (sum_over if stat else sum_replicated)(sums, sharded.sp)
    return sums.unbind(-1)


def _mean(p: torch.Tensor):
    """(map mean (B, T, 1), map size)."""
    sharded = _split()
    if sharded is None:
        return torch.mean(p, dim=-1, keepdim=True), p.shape[-1]
    total, n = _map_sums(p, torch.ones_like(p), stat=True)
    return (total / n)[..., None], n[..., None]


def kld_loss(pred_log: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """KL divergence, map-summed per (B, T); pred is log-probabilities."""
    p = _flat(pred_log)
    t = _flat(target)
    return _map_sums(torch.xlogy(t, t) - t * p, stat=False)[0]


def nss(pred: torch.Tensor, fixations: torch.Tensor) -> torch.Tensor:
    """Normalized Scanpath Saliency per (B, T); pred in probability space."""
    p = _flat(pred)
    f = _flat(fixations) > 0.5
    mean, n = _mean(p)
    if _split() is None:
        std = torch.std(p, dim=-1, keepdim=True, correction=1)
    else:
        std = torch.sqrt(_map_sums((p - mean) ** 2, stat=True)[0][..., None]
                         / (n - 1))
    normed = (p - mean) / torch.clamp(std, min=1e-12)
    total, count = _map_sums(torch.where(f, normed, torch.zeros_like(normed)),
                             f.to(p.dtype), stat=False)
    val = total / torch.clamp(count, min=1)
    return torch.where(count > 0, val, torch.ones_like(val))


def corr_coeff(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Pearson correlation per (B, T); pred in probability space."""
    p = _flat(pred)
    t = _flat(target)
    p_mean, n = _mean(p)
    pm = p - p_mean
    tm = t - _mean(t)[0]
    if _split() is None:
        num = torch.mean(pm * tm, dim=-1)
        den = torch.sqrt(torch.mean(pm ** 2, dim=-1)
                         * torch.mean(tm ** 2, dim=-1))
    else:
        n = n[..., 0]
        num, pp, tt = _map_sums(pm * tm, pm ** 2, tm ** 2, stat=False)
        num, den = num / n, torch.sqrt((pp / n) * (tt / n))
    return num / torch.clamp(den, min=1e-12)


def loss_sequences(pred_log, sal, fix, metrics=('kld', 'nss', 'cc')):
    """Per-metric (B, T) losses (reference ``train.py:410-423``)."""
    out = []
    for m in metrics:
        if m == 'kld':
            out.append(kld_loss(pred_log, sal))
        elif m == 'nss':
            out.append(nss(torch.exp(pred_log), fix))
        elif m == 'cc':
            out.append(corr_coeff(torch.exp(pred_log), sal))
        else:
            raise ValueError(f'unknown metric {m!r}')
    return out
