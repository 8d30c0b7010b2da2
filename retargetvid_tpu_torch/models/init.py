"""Seeded random initialisation of the port's models.

Convolution and linear weights are drawn from an explicit
``torch.Generator`` (LeCun normal, the JAX models' kernel init) and their
biases set to zero; BatchNorm, the Gaussian priors and the smoothing
factors keep their construction values, as a JAX ``init`` leaves them.
"""

from __future__ import annotations

import math

import torch
from torch import nn

__all__ = ["seeded_init_"]


@torch.no_grad()
def seeded_init_(module: nn.Module, seed: int) -> nn.Module:
    gen = torch.Generator(device='cpu').manual_seed(int(seed))
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.Linear)):
            w = m.weight
            fan_in = w[0].numel()
            w.copy_(torch.randn(w.shape, generator=gen)
                    / math.sqrt(fan_in))
            if m.bias is not None:
                m.bias.zero_()
    return module
