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
"""

from __future__ import annotations

import torch

__all__ = ["kld_loss", "nss", "corr_coeff", "loss_sequences"]


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], x.shape[1], -1)


def kld_loss(pred_log: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """KL divergence, map-summed per (B, T); pred is log-probabilities."""
    p = _flat(pred_log)
    t = _flat(target)
    return torch.sum(torch.xlogy(t, t) - t * p, dim=-1)


def nss(pred: torch.Tensor, fixations: torch.Tensor) -> torch.Tensor:
    """Normalized Scanpath Saliency per (B, T); pred in probability space."""
    p = _flat(pred)
    f = _flat(fixations) > 0.5
    mean = torch.mean(p, dim=-1, keepdim=True)
    std = torch.std(p, dim=-1, keepdim=True, correction=1)
    normed = (p - mean) / torch.clamp(std, min=1e-12)
    count = torch.sum(f, dim=-1)
    val = torch.sum(torch.where(f, normed, torch.zeros_like(normed)),
                    dim=-1) / torch.clamp(count, min=1)
    return torch.where(count > 0, val, torch.ones_like(val))


def corr_coeff(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Pearson correlation per (B, T); pred in probability space."""
    p = _flat(pred)
    t = _flat(target)
    pm = p - torch.mean(p, dim=-1, keepdim=True)
    tm = t - torch.mean(t, dim=-1, keepdim=True)
    num = torch.mean(pm * tm, dim=-1)
    den = torch.sqrt(torch.mean(pm ** 2, dim=-1) * torch.mean(tm ** 2, dim=-1))
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
