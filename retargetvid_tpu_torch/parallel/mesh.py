"""The (dp, sp, tp) mesh over a process group, and the sharding rules.

Port of ``retargetvid_tpu/parallel/mesh.py``.  The JAX package builds a
``jax.sharding.Mesh`` over the devices of one controller; the port runs one
process per GPU joined by ``torch.distributed`` (``parallel.distributed``),
so a mesh here is the group's ranks laid out row-major over the axes, as
JAX lays its device list out with ``reshape(axis_sizes)``:

- ``dp``: data parallel; clips and frame batches split over it (the
  benchmark is embarrassingly parallel over videos);
- ``sp``: spatial parallel; the frame H axis splits over it;
- ``tp``: tensor parallel; wide output channels split over it.

Each rank knows its coordinates and its device.  Without an initialized
process group, :func:`make_mesh` is a world of 1 on the caller's device.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from retargetvid_tpu_torch.device import resolve_device

__all__ = ["make_mesh", "batch_sharding", "param_shardings", "AXES", "Mesh",
           "Sharding", "mesh_shape"]

AXES = ('dp', 'sp', 'tp')


def _factorize(n: int) -> tuple:
    """Split n devices over (dp, sp, tp), favouring dp: the benchmark is
    parallel over clips; model parallelism takes explicit ``axis_sizes``."""
    return (n, 1, 1)


def mesh_shape(n_devices: int, axis_sizes: Optional[Sequence[int]] = None
               ) -> dict:
    """``{'dp': .., 'sp': .., 'tp': ..}`` of a mesh over ``n_devices``, as
    JAX's ``make_mesh(n_devices, axis_sizes).shape``."""
    if axis_sizes is None:
        axis_sizes = _factorize(n_devices)
    axis_sizes = tuple(int(s) for s in axis_sizes)
    if len(axis_sizes) != len(AXES) or int(np.prod(axis_sizes)) != n_devices:
        raise ValueError(f'axis sizes {axis_sizes} do not lay out '
                         f'{n_devices} devices over {AXES}')
    return dict(zip(AXES, axis_sizes))


def _device_of(device) -> torch.device:
    """The device with its index made explicit: ``cuda`` means the current
    device, which differs per thread."""
    device = resolve_device(device)
    if device.type == 'cuda' and device.index is None:
        device = torch.device('cuda', torch.cuda.current_device())
    return device


class Mesh:
    """A (dp, sp, tp) layout of ``prod(axis_sizes)`` ranks, row-major.

    ``shape`` maps each axis to its size (JAX's ``mesh.shape``); ``rank``
    is this process's rank in the mesh and ``coords`` its coordinate on each
    axis; ``device`` is where it computes; ``group`` the process group the
    mesh's collectives run on (``None``: no group, a world of 1).
    """

    def __init__(self, axis_sizes: Sequence[int], rank: int = 0,
                 device=None, group=None):
        axis_sizes = tuple(int(s) for s in axis_sizes)
        self.shape = mesh_shape(int(np.prod(axis_sizes)), axis_sizes)
        self.size = int(np.prod(axis_sizes))
        if not 0 <= rank < self.size:
            raise ValueError(f'rank {rank} outside a mesh of {self.size}')
        self.rank = rank
        self.coords = dict(zip(AXES, (int(c) for c in np.unravel_index(
            rank, tuple(self.shape.values())))))
        self.device = _device_of(device)
        self.group = group

    @property
    def dp_index(self) -> int:
        return self.coords['dp']

    def ranks_on(self, **coords) -> list:
        """The ranks whose coordinates equal ``coords`` on the axes named."""
        return [r for r in range(self.size) if all(
            int(c) == coords[a] for a, c in zip(AXES, np.unravel_index(
                r, tuple(self.shape.values()))) if a in coords)]

    def __repr__(self):
        return (f'Mesh({self.shape}, rank={self.rank}, coords={self.coords},'
                f' device={self.device})')


def make_mesh(n_devices: Optional[int] = None,
              axis_sizes: Optional[Sequence[int]] = None,
              device=None) -> Mesh:
    """A (dp, sp, tp) mesh over the process group's ranks, one rank per
    device.

    ``n_devices`` defaults to the world size and must equal it (every
    process of the group is one device of the mesh); without an
    initialized group the mesh is a world of 1 with no collectives.
    ``device=None`` means this process's GPU.
    """
    if dist.is_available() and dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        group = dist.group.WORLD
    else:
        world, rank, group = 1, 0, None
    if n_devices is None:
        n_devices = world
    if n_devices != world:
        raise ValueError(f'a mesh of {n_devices} devices in a world of '
                         f'{world} processes: start one process per device')
    return Mesh(mesh_shape(n_devices, axis_sizes).values(), rank=rank,
                device=device, group=group)


class Sharding:
    """How a host-replicated array splits over the mesh: ``spec`` names the
    mesh axis each dimension splits over (``None``: whole), as JAX's
    ``PartitionSpec``; an empty ``spec`` replicates."""

    def __init__(self, mesh: Mesh, spec: Sequence[Optional[str]] = ()):
        self.mesh = mesh
        self.spec = tuple(spec)

    def local_index(self, shape: Sequence[int]) -> tuple:
        """The slices of this rank's block of an array of ``shape``; a
        split dimension must divide evenly."""
        index = []
        for dim, size in enumerate(shape):
            axis = self.spec[dim] if dim < len(self.spec) else None
            if axis is None:
                index.append(slice(None))
                continue
            n = self.mesh.shape[axis]
            if size % n:
                raise ValueError(f'dimension {dim} of size {size} does not '
                                 f'split evenly over {axis}={n}')
            k = size // n
            c = self.mesh.coords[axis]
            index.append(slice(c * k, (c + 1) * k))
        return tuple(index)


def batch_sharding(mesh: Mesh, ndim: int, *, batch_axis: int = 0,
                   spatial_axis: Optional[int] = None) -> Sharding:
    """Sharding of an activation batch: B over dp, H over sp."""
    spec = [None] * ndim
    spec[batch_axis] = 'dp'
    if spatial_axis is not None:
        spec[spatial_axis] = 'sp'
    return Sharding(mesh, spec)


def _flax_last_dim(name: str, ndim: int) -> int:
    """The port dimension that holds the JAX leaf's last axis: a conv or
    Dense kernel's output channels (OIHW / OIDHW / (out, in) weights and
    the smoothing factors, ``convert``'s layouts) are dim 0; a leaf copied
    as it is keeps its last axis."""
    leaf = name.rsplit('.', 1)[-1]
    if leaf == 'weight' or leaf.startswith('smoothing'):
        return 0
    return ndim - 1


def param_shardings(mesh: Mesh, params, *, tp_threshold: int = 256) -> dict:
    """Per parameter, the dimension to split over tp, or ``None``
    (replicate).

    JAX splits the last axis (the output channels of HWIO and (in, out)
    kernels) of any leaf of 2 or more dimensions when it is at least
    ``tp_threshold`` and divisible by the tp size; the port applies the same
    test to the dimension that holds that axis in its layout.  ``params``
    is a module (its state dict: parameters and BatchNorm statistics) or a
    mapping of names to tensors.
    """
    tp = mesh.shape['tp']
    if isinstance(params, nn.Module):
        params = params.state_dict()
    if not isinstance(params, Mapping):
        raise TypeError('param_shardings takes a module or a mapping')
    out = {}
    for name, value in params.items():
        shape = tuple(value.shape)
        dim = None
        if len(shape) >= 2:
            d = _flax_last_dim(name, len(shape))
            if shape[d] >= tp_threshold and shape[d] % tp == 0:
                dim = d
        out[name] = dim
    return out
