"""Multi-process runtime: one process per GPU joined by
``torch.distributed``.

Port of ``retargetvid_tpu/parallel/distributed.py``.  The JAX package runs
one controller per host (``jax.distributed``) and keeps three rules, which
hold here per process:

- every process holds the full host-side data (the runners' clip lists are
  host-replicated by construction) and puts only its own shard on its
  device (:func:`global_put`);
- a result split over ``dp`` is all-gathered so that every process returns
  the whole batch as host numpy (:func:`global_fetch`); the runners' outputs
  are KB-scale, and this gather is the only collective of the inference
  paths;
- ranks are global: rank r is device r of the mesh (``parallel.mesh``).

A failed initialization or collective raises: nothing falls back from NCCL
to gloo or to a single process.  Every group has a timeout, so a rank that
dies fails the others' next collective instead of hanging them.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from retargetvid_tpu_torch.device import resolve_device

__all__ = ["initialize", "initialize_from_env", "is_multiprocess",
           "global_put", "global_fetch", "shutdown", "DEFAULT_TIMEOUT_S"]

#: Seconds a collective or the rendezvous waits for the other ranks
#: (``RTV_DIST_TIMEOUT`` overrides it).
DEFAULT_TIMEOUT_S = 600.0
#: Codes of the dtypes ``global_fetch`` compares across ranks.
_DTYPE_CODE = {dt: i for i, dt in enumerate((
    torch.float32, torch.float64, torch.float16, torch.bfloat16, torch.uint8,
    torch.int8, torch.int16, torch.int32, torch.int64, torch.bool))}


def _timeout(seconds: Optional[float]) -> datetime.timedelta:
    if seconds is None:
        seconds = float(os.environ.get('RTV_DIST_TIMEOUT',
                                       DEFAULT_TIMEOUT_S))
    return datetime.timedelta(seconds=seconds)


def initialize(rank: int, world: int, init_method: str,
               backend: str = 'nccl',
               timeout_s: Optional[float] = None) -> None:
    """Join the process group: rank ``rank`` of ``world`` over
    ``init_method`` (``tcp://host:port`` or ``file://<path>``) with
    ``backend`` (``nccl`` for CUDA tensors, ``gloo`` for CPU ones).
    ``timeout_s`` (default ``RTV_DIST_TIMEOUT``, else
    :data:`DEFAULT_TIMEOUT_S`) bounds the rendezvous and every
    collective."""
    if dist.is_initialized():
        raise RuntimeError('a process group is already initialized')
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank,
                            timeout=_timeout(timeout_s))


def initialize_from_env(device=None) -> bool:
    """Join the group named by ``RTV_NUM_PROCS``, ``RTV_PROC_ID`` and
    ``RTV_COORD`` (the JAX package's variables; ``RTV_COORD`` is
    ``host:port`` of rank 0, or a ``tcp://``/``file://`` URL).

    Nothing happens when ``RTV_NUM_PROCS`` is unset or at most 1, or when
    the process already joined a group.  ``device`` (``None``: the GPU)
    picks the backend: on CUDA the process takes GPU ``RTV_LOCAL_RANK``
    (default: its rank modulo the GPUs it sees) as its current device, so
    that ``cuda`` means its own card, and joins over NCCL; on the CPU over
    gloo.  Returns True when it initialized a group of more than one
    process.
    """
    n = int(os.environ.get('RTV_NUM_PROCS', '1'))
    if n <= 1 or dist.is_initialized():
        return False
    rank = int(os.environ['RTV_PROC_ID'])
    coord = os.environ['RTV_COORD']
    if '://' not in coord:
        coord = f'tcp://{coord}'
    dev = resolve_device(device)
    if dev.type == 'cuda':
        local = int(os.environ.get('RTV_LOCAL_RANK',
                                   rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        backend = 'nccl'
    else:
        backend = 'gloo'
    initialize(rank, n, coord, backend)
    return True


def shutdown() -> None:
    """Leave the process group, if this process is in one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def is_multiprocess() -> bool:
    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def global_put(tree, sharding):
    """This rank's block of host-replicated data, on its device.

    ``tree``: arrays or tensors (nested in dicts, lists or tuples), each the
    FULL value, the same on every process; ``sharding``: a
    ``parallel.mesh.Sharding`` (``batch_sharding`` or a replicated one).
    """
    mesh = sharding.mesh

    def put(x):
        x = torch.as_tensor(x)
        return x[sharding.local_index(tuple(x.shape))].to(mesh.device)

    return _map(put, tree)


def global_fetch(t: torch.Tensor, mesh) -> np.ndarray:
    """All-gather each dp shard's ``t`` (equal shapes) into host numpy,
    stacked in dp order on every rank.

    Ranks that share a dp index (sp or tp above 1) hold the same shard; the
    first of them (sp = tp = 0) gives it.  On a world of 1 this is the host
    copy.  Shapes and dtypes that differ between ranks raise on every rank
    (nothing is padded).  Over gloo the tensors travel through the host.
    """
    if mesh.group is None:
        return t.detach().cpu().numpy()[None]
    backend = dist.get_backend(mesh.group)
    dev = t.device if backend == 'nccl' else torch.device('cpu')
    if t.ndim > 8:
        raise ValueError('global_fetch takes at most 8 dimensions')
    meta = torch.tensor([t.ndim, *t.shape, *[-1] * (8 - t.ndim),
                         _DTYPE_CODE[t.dtype]], dtype=torch.int64,
                        device=dev)
    metas = [torch.empty_like(meta) for _ in range(mesh.size)]
    dist.all_gather(metas, meta, group=mesh.group)
    if any(not torch.equal(m, metas[0]) for m in metas):
        raise ValueError('global_fetch: the ranks hold tensors of different '
                         f'shapes or dtypes: {[m.tolist() for m in metas]}')
    src = t.detach().contiguous().to(dev)
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(parts, src, group=mesh.group)
    firsts = [mesh.ranks_on(dp=d, sp=0, tp=0)[0]
              for d in range(mesh.shape['dp'])]
    return torch.stack([parts[r] for r in firsts]).cpu().numpy()
