"""Dropout masks of the saliency model, drawn from an explicit generator.

Every random draw of the model goes through :func:`keep_mask`, looked up
at call time, so a test can substitute one function and hand both this
package and the JAX package the same masks.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

__all__ = ["keep_mask", "dropout"]


def keep_mask(shape: Sequence[int], keep: float,
              generator: Optional[torch.Generator]) -> torch.Tensor:
    """A boolean mask of ``shape``, each entry True with probability
    ``keep``, drawn on the generator's device."""
    if generator is None:
        raise ValueError('a dropout mask needs an explicit torch.Generator')
    return torch.rand(tuple(shape), generator=generator,
                      device=generator.device) < keep


def dropout(x: torch.Tensor, rate: float, mask_shape: Sequence[int],
            generator: Optional[torch.Generator],
            rows: Optional[slice] = None) -> torch.Tensor:
    """flax ``nn.Dropout``: ``where(mask, x / keep, 0)`` with one mask of
    ``mask_shape`` broadcast over ``x``; identity at rate 0, zeros at 1.
    ``rows``: the slice of the mask's leading axis that ``x`` holds (mesh
    training draws the global batch's mask on every rank and keeps its
    own samples, so the masks are the single-device ones)."""
    if rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - rate
    mask = keep_mask(mask_shape, keep, generator)
    if rows is not None:
        mask = mask[rows]
    mask = mask.to(x.device)
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                    device=x.device))
