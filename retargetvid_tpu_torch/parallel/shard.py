"""Mesh training's layout of the model: frame rows over sp, wide output
channels over tp, samples over dp.

The JAX package shards a training batch ``P('dp', None, 'sp', None, None)``
and the wide kernels over tp (``parallel/mesh.py:param_shardings``), and
XLA inserts the halos, gathers and reductions.  Here a :class:`ModelShard`
holds what the model needs to do the same by hand, and :func:`active`
makes it the one the model's layers consult (``current()``; ``None``
outside mesh training, where every layer runs its single-device code):

- **rows (sp):** each level of the network is a global height split into
  contiguous row ranges, one per sp rank.  The input level splits evenly;
  a subsample keeps the global even rows (so a shard that starts on an odd
  row starts its selection one row in) and a resize's output level is the
  encoder's level of that height, so skip connections line up.  Levels
  whose rows do not split evenly (224 rows reach 7 at 1/32: 4 + 3) keep
  uneven shards; nothing is padded.  A level may leave a rank no rows at
  all (64 rows over sp=4 reach 2 at 1/32: 1, 0, 1, 0): that rank holds a
  ``(..., 0, W)`` shard, every op gives it a ``(..., 0, W')`` result that
  autograd still reaches (a conv runs on zero rows extended to one
  window and keeps none of its output), and it takes part in every
  exchange of the level, forward and backward, sending the rows its
  neighbours fetch from it.  A 3x3 conv fetches the neighbours'
  boundary rows (zeros beyond the global edges), a resize fetches the rows
  its taps read (clamped at the global edges, as the single-device
  matrices are), the smoothing fetches ``ksize // 2`` rows of edge-
  replicated halo, from as many ranks as hold them;
- **channels (tp):** a conv whose weight holds fewer output channels than
  the module declares is column-parallel: it computes its channels (a
  depthwise one from the matching input channels) and all-gathers them;
  its input's gradient is all-reduced over tp; a bias, which tp never
  splits, is added after the gather;
- **statistics:** train-mode BatchNorm reduces its moments over dp x sp
  (over dp when the batch's rows are replicated), the losses reduce their
  map sums over sp and their batch means over dp.

Each rank's autograd then yields its share of the global loss's gradient:
the trainer all-reduces the parameter gradients over the same ranks as the
statistics (``stat``).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import numpy as np
import torch
from torch.nn import functional as F

from retargetvid_tpu_torch.ops.resize import _resize_axis, _taps_np, \
    apply_taps
from retargetvid_tpu_torch.parallel.collectives import (
    AxisGroup,
    all_reduce,
    copy_over,
    fetch_rows,
    gather_over,
    RowPlan,
    sum_over,
    sum_replicated,
)

__all__ = ["ModelShard", "active", "current", "split_rows", "conv2d",
           "halve"]

#: Per thread: a server's inference threads never see a training step's
#: shard.
_LOCAL = threading.local()


def current() -> Optional['ModelShard']:
    """This thread's current shard, the one the model's layers follow, or
    ``None``."""
    return getattr(_LOCAL, 'shard', None)


@contextlib.contextmanager
def active(shard: Optional['ModelShard']):
    """Make ``shard`` this thread's current one inside the block."""
    saved = current()
    _LOCAL.shard = shard
    try:
        yield shard
    finally:
        _LOCAL.shard = saved


def halve(h: int) -> int:
    """Rows left by ``x[..., ::2, :]`` (and by the stride-2 stem)."""
    return (h + 1) // 2


def split_rows(h: int, n: int) -> tuple:
    """``h`` rows in ``n`` contiguous shards, the first ``h % n`` one row
    longer."""
    sizes = [h // n + (i < h % n) for i in range(n)]
    starts = np.cumsum([0] + sizes)
    return tuple((int(starts[i]), int(starts[i + 1])) for i in range(n))


def _even_rows(parts) -> tuple:
    return tuple(((s + 1) // 2, (e + 1) // 2) for s, e in parts)


def _conv_rows(x, w, bias, stride, padding, dilation, groups):
    """``F.conv2d`` (``padding`` and ``dilation`` as pairs), also where
    ``x`` holds fewer rows than one window of ``w`` spans (a shard without
    rows at its level, with its halo): then a ``(N, O, 0, W')`` result,
    computed from ``x`` extended by zero rows to one window and cut to
    none, so that autograd still reaches ``x`` (and the exchanges that
    fetched its rows) and gives it a zero gradient."""
    short = (dilation[0] * (w.shape[2] - 1) + 1 - 2 * padding[0]
             - x.shape[-2])
    if short <= 0:
        return F.conv2d(x, w, bias, stride, padding, dilation, groups)
    y = F.conv2d(F.pad(x, (0, 0, 0, short)), w, bias, stride, padding,
                 dilation, groups)
    return y[..., :0, :]


def conv2d(conv, x):
    """``conv(x)``, or its sharded form under the current shard."""
    shard = current()
    return conv(x) if shard is None else shard.conv(conv, x)


class ModelShard:
    """One batch's layout over the mesh (see the module docstring).

    ``height``: the batch's global frame height; ``rows_split``: whether
    its rows are split over sp (``Trainer._shard_batch`` splits them when
    sp divides the height; otherwise the sp ranks hold whole frames and
    compute alike).  Built per batch from ``mesh.groups``.  A level too
    short to give every sp rank a row leaves some ranks an empty shard
    (see the module docstring); the step's result is the single-device
    one all the same.
    """

    def __init__(self, mesh, height: int, rows_split: bool):
        groups = mesh.groups
        self.dp, self.tp = groups['dp'], groups['tp']
        if rows_split:
            self.sp, self.stat = groups['sp'], groups['dpsp']
        else:
            self.sp = AxisGroup((mesh.rank,), 0)
            self.stat = groups['dp']
        self.height = int(height)
        self._parts = {}
        self._plans = {}
        self.at(self.height)

    # -- levels ------------------------------------------------------------
    @property
    def split(self) -> bool:
        return self.sp.size > 1

    def parts(self, h: int) -> tuple:
        """The row shards of the level of global height ``h`` (registered
        by a subsample, else an even split)."""
        if h not in self._parts:
            self._parts[h] = split_rows(h, self.sp.size)
        return self._parts[h]

    def at(self, h: int) -> 'ModelShard':
        """Make ``h`` the current level."""
        self.level = h
        return self

    def rows(self) -> tuple:
        """This rank's ``(start, stop)`` at the current level."""
        return self.parts(self.level)[self.sp.index]

    def descend(self) -> 'ModelShard':
        """Make the level of the current one's global even rows current
        (after a stride-2 conv or a subsample)."""
        h = halve(self.level)
        self._parts.setdefault(h, _even_rows(self.parts(self.level)))
        return self.at(h)

    def subsample(self, x):
        """``x[..., ::2, ::2]`` of the global tensor: the global even rows
        of this rank's shard; their level becomes current."""
        s, _ = self.rows()
        self.descend()
        return x[..., s % 2::2, ::2]

    # -- sample (dp) layout --------------------------------------------------
    def batch_rows(self, n_local: int):
        """The global count and this rank's slice of a leading axis of
        ``n_local`` entries per dp rank (samples, or samples x frames)."""
        i = self.dp.index * n_local
        return n_local * self.dp.size, slice(i, i + n_local)

    def batch_mean(self, v: torch.Tensor) -> torch.Tensor:
        """The mean of ``v`` over the global batch (equal shards)."""
        if self.dp.size == 1:
            return torch.mean(v)
        return sum_replicated(v.sum(), self.dp) / (v.numel() * self.dp.size)

    # -- row exchanges -------------------------------------------------------
    def _plan(self, h: int, kind: str, arg):
        key = (h, kind, arg)
        if key not in self._plans:
            self._plans[key] = self._make_plan(h, kind, arg)
        return self._plans[key]

    def _make_plan(self, h: int, kind: str, arg):
        parts = self.parts(h)
        if kind == 'halo':
            def wanted(i):
                s, e = parts[i]
                return [r if 0 <= r < h else -1
                        for r in range(s - arg, e + arg)]
        elif kind == 'clamp':
            def wanted(i):
                s, e = parts[i]
                return np.clip(np.arange(s - arg, e + arg), 0, h - 1)
        else:                           # resize taps; arg: (h_out, method)
            def wanted(i):
                return self._tap_rows(h, *arg, i)[0]
        return RowPlan(parts, wanted, self.sp.index)

    def _tap_rows(self, h_in: int, h_out: int, method: str, i: int):
        """The rows (ascending) that rank ``i``'s output rows of a resize
        from ``h_in`` to ``h_out`` rows read, and its taps (K, rows)."""
        idx, wts = _taps_np(h_in, h_out, method)
        s, e = self.parts(h_out)[i]
        idx, wts = idx[:, s:e], wts[:, s:e]
        return np.unique(idx[wts != 0]), idx, wts

    def halo(self, x, k: int):
        """This shard's rows with ``k`` rows of the neighbours' on each
        side, zeros beyond the global edges."""
        return fetch_rows(x, -2, self._plan(self.level, 'halo', k), self.sp)

    def conv(self, conv, x):
        """``conv`` (an ``nn.Conv2d``) on this shard: halo rows over sp,
        column-parallel over tp where its weight is split."""
        w, bias, groups = conv.weight, conv.bias, conv.groups
        tp_split = w.shape[0] != conv.out_channels
        if tp_split:
            x = copy_over(x, self.tp)
            if groups > 1:                 # depthwise: the matching inputs
                n = w.shape[0]
                x = x.narrow(1, self.tp.index * n, n)
                groups = n
        (kh, _), (sh, sw), (ph, pw) = conv.kernel_size, conv.stride, \
            conv.padding
        conv_bias = None if tp_split else bias
        if self.split and kh > 1:
            s = self.rows()[0]
            x = self.halo(x, ph)
            if sh > 1:          # the first output row this shard owns
                x = x[..., -(-s // sh) * sh - s:, :]
            y = _conv_rows(x, w, conv_bias, (sh, sw), (0, pw),
                           conv.dilation, groups)
        else:
            y = _conv_rows(x, w, conv_bias, conv.stride, conv.padding,
                           conv.dilation, groups)
        if tp_split:
            y = gather_over(y, 1, self.tp)
            if bias is not None:
                y = y + bias[None, :, None, None]
        return y

    def resize(self, x, out_hw, method: str):
        """``ops.resize.resize(x, out_hw, method, channels_last=False)`` of
        the global tensor at the current level; its output level (the
        encoder's, where one has that height) becomes current."""
        h_out, w_out = int(out_hw[0]), int(out_hw[1])
        if not self.split:
            x = _resize_axis(x, x.ndim - 2, h_out, method)
            self.at(h_out)
            return _resize_axis(x, x.ndim - 1, w_out, method)
        read, idx, wts = self._tap_rows(self.level, h_out, method,
                                        self.sp.index)
        rows = fetch_rows(x, -2, self._plan(self.level, 'taps',
                                            (h_out, method)), self.sp)
        # The taps of weight 0 (padding) read any row: the product is 0.
        pos = np.where(wts != 0, np.searchsorted(read, idx), 0)
        x = apply_taps(rows, x.ndim - 2, pos, wts)
        self.at(h_out)
        return _resize_axis(x, x.ndim - 1, w_out, method)

    def replicate_pad(self, x, pad: int):
        """``F.pad(x, (pad,) * 4, mode='replicate')`` of the global tensor
        at the current level, cut to this shard's rows and their halo."""
        if not self.split:
            return F.pad(x, (pad, pad, pad, pad), mode='replicate')
        x = fetch_rows(x, -2, self._plan(self.level, 'clamp', pad), self.sp)
        return F.pad(x, (pad, pad, 0, 0), mode='replicate')

    def row_slice(self, t, dim: int = -2):
        """This shard's rows of a tensor computed at the full level
        height."""
        s, e = self.rows()
        return t.narrow(dim, s, e - s)

    def log_softmax(self, x):
        """Log-softmax over the two trailing axes of the global map: the
        max and the sum of exponentials reduced over sp."""
        if not self.split:
            return None
        if x.shape[-2] * x.shape[-1]:
            m = x.detach().amax(dim=(-2, -1), keepdim=True)
        else:                           # no rows here: MAX's identity
            m = x.new_full((*x.shape[:-2], 1, 1), float('-inf'))
        m = all_reduce(m, self.sp, torch.distributed.ReduceOp.MAX)
        z = x - m
        s = sum_over(torch.exp(z).sum(dim=(-2, -1), keepdim=True), self.sp)
        return z - torch.log(s)

    # -- statistics ----------------------------------------------------------
    def moments(self, xf):
        """Per-channel mean and biased variance of (N, C, H, W) ``xf`` over
        the global batch's rows (one all-reduce, its gradient reduced too);
        flax's ``E[x^2] - E[x]^2`` clamped at 0."""
        c = xf.shape[1]
        n = xf.new_full((1,), xf.shape[0] * xf.shape[2] * xf.shape[3])
        tot = sum_over(torch.cat([xf.sum(dim=(0, 2, 3)),
                                  (xf * xf).sum(dim=(0, 2, 3)), n]),
                       self.stat)
        mean = tot[:c] / tot[-1]
        var = torch.clamp(tot[c:2 * c] / tot[-1] - mean * mean, min=0.0)
        return mean, var

