"""Carry JAX (flax) parameter trees across to the port's modules.

The port names its submodules after the JAX parameter tree, so a leaf at
``a/b/c/kernel`` lands in ``a.b.c.weight``.  Layouts change on the way:

- conv kernels DHWIO -> OIDHW and HWIO -> OIHW (a depthwise (k, k, 1, C)
  becomes (C, 1, k, k); the smoothing factors (k, 1, 1, r) and (1, k, r, 1)
  become (r, 1, k, 1) and (1, r, 1, k), the full smoothing kernel
  (k, k, 1, 1) becomes (1, 1, k, k));
- ``Dense`` kernels (in, out) -> ``Linear`` weights (out, in).  TransNet's
  ``dense1`` rows keep their (h, w, c) order because the port flattens
  channels-last, as the JAX model does;
- BatchNorm ``scale``/``bias`` (params) and ``mean``/``var``
  (batch_stats) -> ``weight``/``bias``/``running_mean``/``running_var``.

The inputs are the JAX trees as nested dicts of numpy arrays
(``jax.tree_util.tree_map(np.asarray, variables)``); nothing here imports
JAX.  :func:`state_dict_to_flax` goes the other way, so the port writes
weights and checkpoints in the JAX package's pickle format.

A model trained on a mesh with tp holds only its rank's output channels of
the split weights; its JAX tree is still the full one: the trainer
gathers the split leaves and passes them as ``values`` to
:func:`state_dict_to_flax`, and :func:`load_flax_variables` cuts each split
leaf of a full tree to the rank's channels (``shards``).
"""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np
import torch
from torch import nn

__all__ = ["flax_to_state_dict", "load_flax_variables",
           "state_dict_to_flax", "flax_param_tree", "flax_name",
           "shard_entries"]

_STAT_NAMES = {'mean': 'running_mean', 'var': 'running_var'}
#: Inverse axis orders of the kernel layouts above (OI... -> ...IO).
_KERNEL_BACK = {5: (2, 3, 4, 1, 0), 4: (2, 3, 1, 0), 2: (1, 0)}


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
    if leaf.startswith('smoothing'):
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
                        skip: Iterable[str] = (),
                        shards: Optional[dict] = None) -> nn.Module:
    """Fill every parameter and BatchNorm statistic of ``module`` from the
    JAX trees; raises on a missing, extra or misshapen entry.  Top-level
    subtrees named in ``skip`` are left out on both sides: the module's
    own entries under them keep their values.  ``shards``: port name ->
    ``(dim, index, parts)``, the entries the module holds a slice of (its
    ``index``-th of ``parts`` equal slices along ``dim``)."""
    skip = set(skip)
    converted = shard_entries(flax_to_state_dict(variables, skip), shards)
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


def shard_entries(entries: dict, shards: Optional[dict]) -> dict:
    """``entries`` (name -> tensor) with each entry named in ``shards``
    cut to its slice (see :func:`load_flax_variables`)."""
    out = dict(entries)
    for name, (dim, index, parts) in (shards or {}).items():
        if name in out:
            n = out[name].shape[dim] // parts
            out[name] = out[name].narrow(dim, index * n, n).clone()
    return out


def flax_name(path) -> str:
    """The port's parameter name of the JAX parameter at ``path`` (a
    sequence of keys, e.g. ``('cnn', 'features_0', 'conv', 'kernel')``)."""
    names, _ = _param(list(path), np.zeros((1,) * 4))
    return '.'.join(names)


def _nest(tree: dict, path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def flax_param_tree(module: nn.Module, values: Optional[dict] = None
                    ) -> dict:
    """The port's parameters as the JAX ``params`` tree (float32 numpy).
    ``values`` (port name -> tensor, e.g. an optimizer trace) replaces the
    parameters' own values; a parameter missing from it is left out."""
    tree: dict = {}
    for mod_name, mod in module.named_modules():
        path = mod_name.split('.') if mod_name else []
        is_bn = isinstance(mod, nn.modules.batchnorm._BatchNorm)
        for name, p in mod.named_parameters(recurse=False):
            if values is not None:
                full = '.'.join(path + [name])
                if full not in values:
                    continue
                p = values[full]
            arr = p.detach().float().cpu().numpy()
            if name == 'weight' and not is_bn:
                _nest(tree, path + ['kernel'],
                      arr.transpose(_KERNEL_BACK[arr.ndim]))
            elif name == 'weight':
                _nest(tree, path + ['scale'], arr)
            elif name.startswith('smoothing'):
                _nest(tree, path + [name], arr.transpose(2, 3, 1, 0))
            else:
                _nest(tree, path + [name], arr)
    return tree


def state_dict_to_flax(module: nn.Module, values: Optional[dict] = None
                       ) -> dict:
    """The port's parameters and BatchNorm statistics as the JAX trees
    ``{'params': ..., 'batch_stats': ...}`` of float32 numpy arrays (the
    inverse of :func:`flax_to_state_dict`).  ``values`` (name -> tensor)
    replaces parameters' own values, as in :func:`flax_param_tree`; the
    others keep theirs."""
    stats: dict = {}
    for mod_name, mod in module.named_modules():
        if isinstance(mod, nn.modules.batchnorm._BatchNorm):
            path = mod_name.split('.') if mod_name else []
            for flax_stat, buf in _STAT_NAMES.items():
                _nest(stats, path + [flax_stat],
                      getattr(mod, buf).detach().float().cpu().numpy())
    if values is not None:
        values = {**dict(module.named_parameters()), **values}
    return {'params': flax_param_tree(module, values), 'batch_stats': stats}
