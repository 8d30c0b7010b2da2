"""What a run feeds both sides, made on the device from ``--seed``.

Weights: every conv and dense weight of a model is drawn in one
``torch.randn`` call on a generator on the device, cut into leaves and
scaled LeCun-normal (1/sqrt(fan in)); biases are zero and everything else
(BatchNorm statistics, UNISAL's Gaussian priors and smoothing factors)
keeps its construction value.  A configuration may set a dense layer's bias
(TransNet's ``head_bias``).  The same tensors load into the program and
into the reference.

Clips: the formula of the repository's bench clip (a Gaussian blob moving
left to right over seeded uniform noise in [0, 60)), one noise field per
clip, drawn on the device.
"""

from __future__ import annotations

import math

import torch
from torch import nn

_WEIGHTED = (nn.Conv1d, nn.Conv2d, nn.Conv3d, nn.Linear)


def _mix(seed: int, salt: int) -> int:
    """A 63-bit generator seed from the run's seed and a salt."""
    return (int(seed) * 0x9E3779B97F4A7C15 + salt) % (2 ** 63)


@torch.no_grad()
def seed_weights_(model: nn.Module, seed: int, salt: int, device,
                  biases: dict | None = None) -> nn.Module:
    """Fill ``model`` (already on ``device``) in place; ``biases`` maps a
    submodule name to the values of its bias."""
    layers = [m for m in model.modules() if isinstance(m, _WEIGHTED)]
    total = sum(m.weight.numel() for m in layers)
    gen = torch.Generator(device=device).manual_seed(_mix(seed, salt))
    noise = torch.randn(total, generator=gen, device=device)
    off = 0
    for m in layers:
        n = m.weight.numel()
        m.weight.copy_(noise[off:off + n].view_as(m.weight)
                       / math.sqrt(m.weight[0].numel()))
        off += n
        if m.bias is not None:
            m.bias.zero_()
    for name, values in (biases or {}).items():
        model.get_submodule(name).bias.copy_(torch.tensor(values))
    return model


def state_of(model: nn.Module) -> dict:
    """A detached copy of the model's state (what the reference loads)."""
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


@torch.no_grad()
def clip_pool(n_clips: int, frames: int, h: int, w: int, seed: int,
              device) -> list:
    """``n_clips`` distinct (frames, h, w, 3) uint8 clips on the device."""
    gen = torch.Generator(device=device).manual_seed(_mix(seed, 7))
    t = torch.arange(frames, device=device, dtype=torch.float32)
    lin = t / max(frames - 1, 1)
    cx = w * (0.2 + 0.6 * lin)
    cy = h * (0.5 + 0.2 * torch.sin(8.0 * lin))
    yy = torch.arange(h, device=device, dtype=torch.float32)
    xx = torch.arange(w, device=device, dtype=torch.float32)
    dy2 = (yy[None, :] - cy[:, None]) ** 2                  # (T, h)
    dx2 = (xx[None, :] - cx[:, None]) ** 2                  # (T, w)
    blob = 200.0 * torch.exp(-(dy2[:, :, None] + dx2[:, None, :]) / 2500.0)
    pool = []
    for _ in range(n_clips):
        base = torch.randint(0, 60, (h, w, 3), generator=gen, device=device)
        clip = torch.clamp(base.to(torch.float32)[None]
                           + blob[..., None], 0, 255)
        pool.append(clip.to(torch.uint8))
    return pool
