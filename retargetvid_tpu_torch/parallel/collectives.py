"""Collectives that autograd passes through, over one axis of the mesh.

The JAX package trains on a mesh by annotating shardings and letting XLA
insert every collective.  The port's mesh training (``parallel/shard.py``)
places them by hand, so each is a ``torch.autograd.Function`` whose
backward is the collective the chain rule asks for:

- :func:`sum_over`: all-reduce sum; backward all-reduce sum.  For a
  statistic that every rank then applies to its own rows (BatchNorm's
  moments, the losses' means): each rank's gradient of it is a partial.
- :func:`sum_replicated`: all-reduce sum; backward identity.  For a value
  that every rank then consumes the same way (a loss): each rank's
  gradient of it is already the whole.
- :func:`copy_over`: identity; backward all-reduce sum.  The input of a
  column-parallel conv: each tp rank differentiates its own channels.
- :func:`gather_over`: all-gather along a dimension; backward this rank's
  slice.
- :func:`fetch_rows`: rows of a tensor split by rows over the group,
  fetched by global index (halos, resize taps); backward sends each
  fetched row's gradient back to its owner, which adds it.

A group is an :class:`AxisGroup`; one of size 1 makes every collective the
identity.  **Backends.**  NCCL keeps the tensors on the device.  Gloo
offers only broadcast and all-reduce on CUDA tensors (no send/recv, no
all-gather), so over gloo every tensor goes through the host, as
``distributed.global_fetch`` does; the choice follows the group's backend,
never an error.  Every group carries the process group's timeout: a rank
that dies fails the others' next collective, which raises.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["AxisGroup", "all_reduce", "sum_over", "sum_replicated",
           "copy_over", "gather_over", "fetch_rows", "RowPlan", "barrier"]


class AxisGroup:
    """This rank's group along one axis: ``ranks`` (global, ascending),
    ``index`` (this rank's position, its coordinate on the axis) and the
    process group ``pg`` (``None`` for a group of one rank)."""

    def __init__(self, ranks: Sequence[int], index: int, pg=None):
        self.ranks = tuple(int(r) for r in ranks)
        self.index = int(index)
        self.pg = pg
        if self.size > 1 and pg is None:
            raise ValueError('a group of several ranks needs a process '
                             'group')

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def host_staged(self) -> bool:
        """True where the tensors travel through the host (gloo)."""
        return self.pg is not None and dist.get_backend(self.pg) == 'gloo'

    def __repr__(self):
        return f'AxisGroup(ranks={self.ranks}, index={self.index})'


def _stage(t: torch.Tensor, group: AxisGroup) -> torch.Tensor:
    t = t.contiguous()
    return t.cpu() if group.host_staged else t


def all_reduce(t: torch.Tensor, group: AxisGroup,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """A new tensor: ``t`` reduced with ``op`` over ``group``."""
    if group.size == 1:
        return t.clone()
    buf = _stage(t, group)
    if buf is t:
        buf = t.clone()
    dist.all_reduce(buf, op=op, group=group.pg)
    return buf.to(t.device)


def barrier(group: AxisGroup, device) -> None:
    """Every rank of ``group`` waits for the others: an all-reduce of one
    value on ``device`` (the rank's: NCCL takes only CUDA tensors)."""
    if group.size > 1:
        all_reduce(torch.zeros(1, device=device), group)


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _SumReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


def _all_gather(t: torch.Tensor, group: AxisGroup) -> list:
    buf = _stage(t, group)
    parts = [torch.empty_like(buf) for _ in range(group.size)]
    dist.all_gather(parts, buf, group=group.pg)
    return [p.to(t.device) for p in parts]


class _GatherOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group, ctx.n = dim, group, x.shape[dim]
        return torch.cat(_all_gather(x, group), dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.group.index * ctx.n,
                        ctx.n).contiguous(), None, None


def sum_over(x: torch.Tensor, group: AxisGroup) -> torch.Tensor:
    """All-reduce sum; its gradient is all-reduced too (see the module
    docstring)."""
    return x if group.size == 1 else _SumOver.apply(x, group)


def sum_replicated(x: torch.Tensor, group: AxisGroup) -> torch.Tensor:
    """All-reduce sum whose gradient passes unchanged."""
    return x if group.size == 1 else _SumReplicated.apply(x, group)


def copy_over(x: torch.Tensor, group: AxisGroup) -> torch.Tensor:
    """Identity whose gradient is all-reduced."""
    return x if group.size == 1 else _CopyOver.apply(x, group)


def gather_over(x: torch.Tensor, dim: int, group: AxisGroup
                ) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) concatenated along ``dim`` in
    group order; the gradient keeps this rank's slice."""
    if group.size == 1:
        return x
    return _GatherOver.apply(x, dim % x.ndim, group)


# -- rows split over a group ------------------------------------------------

def _owner(parts, row: int) -> int:
    for i, (s, e) in enumerate(parts):
        if s <= row < e:
            return i
    raise ValueError(f'row {row} is outside the partition {parts}')


class RowPlan:
    """Who sends which rows to whom so that rank ``index`` of the group
    holds rows ``wanted(index)`` (global indices, in order; -1 gives a row
    of zeros) of a tensor split by ``parts``, contiguous ``(start, stop)``
    per rank.  Every rank builds every rank's plan from the same
    arguments, so each send meets its receive."""

    def __init__(self, parts, wanted: Callable[[int], Sequence[int]],
                 index: int):
        self.parts = tuple(tuple(p) for p in parts)
        want = [np.asarray(wanted(i), np.int64)
                for i in range(len(self.parts))]
        own = [np.array([-1 if r < 0 else _owner(self.parts, int(r))
                         for r in w], np.int64) for w in want]
        s_me = self.parts[index][0]
        mine, owner = want[index], own[index]
        self.n_out = len(mine)
        self.local_pos = np.nonzero(owner == index)[0]
        self.local_src = mine[self.local_pos] - s_me
        #: (src, the positions here its rows fill)
        self.recvs = [(j, np.nonzero(owner == j)[0])
                      for j in range(len(self.parts)) if j != index
                      and (owner == j).any()]
        #: (dst, this rank's local rows it wants)
        self.sends = [(j, want[j][own[j] == index] - s_me)
                      for j in range(len(self.parts)) if j != index
                      and (own[j] == index).any()]


def _index(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _exchange(group: AxisGroup, sends, recv_shapes, like: torch.Tensor):
    """Post every send and receive of one exchange at once; returns the
    received tensors on ``like``'s device."""
    dev = torch.device('cpu') if group.host_staged else like.device
    ops, bufs = [], []
    for dst, t in sends:
        ops.append(dist.P2POp(dist.isend, t.contiguous().to(dev),
                              group.ranks[dst], group.pg))
    for src, shape in recv_shapes:
        buf = torch.empty(shape, dtype=like.dtype, device=dev)
        bufs.append(buf)
        ops.append(dist.P2POp(dist.irecv, buf, group.ranks[src], group.pg))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return [b.to(like.device) for b in bufs]


def _rows_shape(x, dim, n):
    shape = list(x.shape)
    shape[dim] = n
    return tuple(shape)


class _FetchRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, plan, group):
        ctx.dim, ctx.plan, ctx.group = dim, plan, group
        ctx.x_shape = tuple(x.shape)
        dev = x.device
        out = x.new_zeros(_rows_shape(x, dim, plan.n_out))
        if len(plan.local_pos):
            out.index_copy_(dim, _index(plan.local_pos, dev),
                            x.index_select(dim, _index(plan.local_src, dev)))
        got = _exchange(group, [(j, x.index_select(dim, _index(rows, dev)))
                                for j, rows in plan.sends],
                        [(j, _rows_shape(x, dim, len(pos)))
                         for j, pos in plan.recvs], x)
        for (_, pos), buf in zip(plan.recvs, got):
            out.index_copy_(dim, _index(pos, dev), buf)
        return out

    @staticmethod
    def backward(ctx, g):
        plan, dim, dev = ctx.plan, ctx.dim, g.device
        gx = g.new_zeros(ctx.x_shape)
        if len(plan.local_pos):
            gx.index_add_(dim, _index(plan.local_src, dev),
                          g.index_select(dim, _index(plan.local_pos, dev)))
        got = _exchange(ctx.group, [(j, g.index_select(dim, _index(pos, dev)))
                                    for j, pos in plan.recvs],
                        [(j, _rows_shape(g, dim, len(rows)))
                         for j, rows in plan.sends], g)
        for (_, rows), buf in zip(plan.sends, got):
            gx.index_add_(dim, _index(rows, dev), buf)
        return gx, None, None, None


def fetch_rows(x: torch.Tensor, dim: int, plan: RowPlan,
               group: Optional[AxisGroup]) -> torch.Tensor:
    """The rows ``plan`` names of the tensor split along ``dim`` over
    ``group``, in the plan's order (-1: zeros)."""
    return _FetchRows.apply(x, dim % x.ndim, plan, group)
