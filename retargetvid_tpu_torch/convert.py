"""Carry JAX (flax) parameter trees across to the port's modules.

The port names its submodules after the JAX parameter tree, so a leaf at
``a/b/c/kernel`` lands in ``a.b.c.weight``.  Layouts change on the way:

- conv kernels DHWIO -> OIDHW and HWIO -> OIHW (a depthwise (k, k, 1, C)
  becomes (C, 1, k, k); the smoothing factors (k, 1, 1, r) and (1, k, r, 1)
  become (r, 1, k, 1) and (1, r, 1, k));
- ``Dense`` kernels (in, out) -> ``Linear`` weights (out, in).  TransNet's
  ``dense1`` rows keep their (h, w, c) order because the port flattens
  channels-last, as the JAX model does;
- BatchNorm ``scale``/``bias`` (params) and ``mean``/``var``
  (batch_stats) -> ``weight``/``bias``/``running_mean``/``running_var``.

The inputs are the JAX trees as nested dicts of numpy arrays
(``jax.tree_util.tree_map(np.asarray, variables)``); nothing here imports
JAX.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch
from torch import nn

__all__ = ["flax_to_state_dict", "load_flax_variables"]

_STAT_NAMES = {'mean': 'running_mean', 'var': 'running_var'}


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, 'items'):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _param(path, value):
    *mods, leaf = path
    if leaf == 'kernel':
        perm = {5: (4, 3, 0, 1, 2), 4: (3, 2, 0, 1), 2: (1, 0)}[value.ndim]
        return mods + ['weight'], value.transpose(perm)
    if leaf.startswith('smoothing_v_') or leaf.startswith('smoothing_h_'):
        return mods + [leaf], value.transpose(3, 2, 0, 1)
    if leaf == 'scale':
        return mods + ['weight'], value
    return mods + [leaf], value


def flax_to_state_dict(variables: dict,
                       skip: Iterable[str] = ()) -> dict:
    """JAX ``{'params': ..., 'batch_stats': ...}`` -> port state-dict
    entries (float32 tensors).  Top-level subtrees named in ``skip`` are
    left out (parts of the JAX model the port does not have)."""
    skip = set(skip)
    out = {}
    for path, value in _flatten(variables.get('params', {})):
        if path[0] in skip:
            continue
        names, arr = _param(path, value)
        out['.'.join(names)] = arr
    for path, value in _flatten(variables.get('batch_stats', {})):
        if path[0] in skip:
            continue
        out['.'.join(path[:-1] + (_STAT_NAMES[path[-1]],))] = value
    return {k: torch.from_numpy(np.array(v, np.float32))
            for k, v in out.items()}


def load_flax_variables(module: nn.Module, variables: dict,
                        skip: Iterable[str] = ()) -> nn.Module:
    """Fill every parameter and BatchNorm statistic of ``module`` from the
    JAX trees; raises on a missing, extra or misshapen entry.  Top-level
    subtrees named in ``skip`` are left out on both sides: the module's
    own entries under them keep their values."""
    skip = set(skip)
    converted = flax_to_state_dict(variables, skip)
    state = module.state_dict()
    kept = [k for k in state if k.split('.', 1)[0] not in skip]
    extra = sorted(set(converted) - set(kept))
    missing = sorted(k for k in kept if k not in converted
                     and not k.endswith('num_batches_tracked'))
    if extra or missing:
        raise KeyError(f'flax tree does not match the module: extra '
                       f'{extra[:6]}, missing {missing[:6]}')
    for k, v in converted.items():
        if tuple(state[k].shape) != tuple(v.shape):
            raise ValueError(f'shape mismatch at {k}: module '
                             f'{tuple(state[k].shape)} vs tree '
                             f'{tuple(v.shape)}')
        state[k] = v.to(state[k].dtype)
    module.load_state_dict(state, strict=True)
    return module
