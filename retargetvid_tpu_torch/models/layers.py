"""Shared building blocks of the saliency model (PyTorch, NCHW).

Ports of ``retargetvid_tpu/models/layers.py``: ``ConvBN`` and ``Conv1x1BN``
(conv + BatchNorm + ReLU6), ``InvertedResidual`` (MobileNetV2 block with the
reference's ``omit_stride`` quirk) and ``DomainBN`` (one set of BatchNorm
statistics per source).  Submodule names follow the JAX parameter tree, so
``convert`` maps every leaf by its path.

:class:`BatchNorm` keeps flax's semantics, not torch's.  Its explicit
``bn_train`` flag (never ``nn.Module.training``) selects train mode: the
batch's statistics normalize and the running statistics move as
``new = m*old + (1-m)*batch`` with flax's momentum ``m`` and the *biased*
variance ``E[x^2] - E[x]^2`` clipped at 0 (flax 0.12.3 ``_compute_stats``,
``use_fast_variance=True``).  Off, it normalizes with the running
statistics.

Under mesh training (``parallel/shard.py``) each conv runs through
``shard.conv2d`` (row halos over sp, column-parallel over tp) and
train-mode BatchNorm takes its moments over the ranks that split the batch
(SyncBN: the gradient flows through the reduced moments), so every rank's
running statistics agree.

Every BatchNorm of these blocks and of UNISAL's skip connections goes
through :func:`bn_act` with the ReLU6 or residual add that follows it: in
inference on the card (a CUDA tensor, no gradient recorded, the BatchNorm
in eval mode) as one pass of the CUDA kernel ``kernels/bn_act.py``,
otherwise as the separate ops.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from retargetvid_tpu_torch.kernels import bn_act as bn_act_kernel
from retargetvid_tpu_torch.parallel import shard

DEFAULT_SOURCES = ('DHF1K', 'Hollywood', 'UCFSports', 'SALICON')
_BN_EPS = 1e-5


def relu6(x):
    """``min(max(x, 0), 6)``.  Where a gradient is taken, as JAX's
    ``jnp.minimum(jnp.maximum(x, 0), 6)``, whose gradient is split in half
    at the ties x == 0 and x == 6 (``torch.clamp`` passes all of it): the
    ConvGRU's zero first hidden state meets the tie exactly, and training
    then drifts from JAX's.  Otherwise one clamp."""
    if torch.is_grad_enabled() and x.requires_grad:
        return torch.minimum(torch.maximum(x, x.new_zeros(())),
                             x.new_full((), 6.0))
    return torch.clamp(x, 0.0, 6.0)


def batch_norm_eval(bn: nn.BatchNorm2d, x):
    """BatchNorm with the running statistics (eval mode)."""
    return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                        bn.bias, training=False, eps=_BN_EPS)


def _ch(v):                                         # (C,) -> (1, C, 1, 1)
    return v[None, :, None, None]


class BatchNorm(nn.BatchNorm2d):
    """flax ``nn.BatchNorm`` over NCHW (see the module docstring).

    ``momentum`` is flax's (= 1 - torch's): 0.99 for the model's plain
    BatchNorms and the dynamic sources, 0.9 for SALICON.
    """

    def __init__(self, ch: int, momentum: float = 0.99):
        super().__init__(ch, eps=_BN_EPS)
        self.flax_momentum = momentum
        self.bn_train = False

    def forward(self, x):
        if not self.bn_train:
            return batch_norm_eval(self, x)
        xf = x.float()
        sharded = shard.current()
        if sharded is not None and sharded.stat.size > 1:
            mean, var = sharded.moments(xf)
        else:
            mean = xf.mean(dim=(0, 2, 3))
            var = torch.clamp((xf * xf).mean(dim=(0, 2, 3)) - mean * mean,
                              min=0.0)
        with torch.no_grad():
            m = self.flax_momentum
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1 - m) * var)
        y = (x - _ch(mean)) * _ch(torch.rsqrt(var + _BN_EPS) * self.weight)
        return (y + _ch(self.bias)).to(x.dtype)


def set_bn_train(module: nn.Module, flag: bool) -> None:
    """Set ``bn_train`` on every :class:`BatchNorm` under ``module``."""
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.bn_train = flag


class DomainBN(nn.Module):
    """Domain-specific BatchNorm: ``bn_<source>`` per source; only the
    active source's statistics are used and, in train mode, updated."""

    def __init__(self, ch: int, sources: Sequence[str] = DEFAULT_SOURCES):
        super().__init__()
        self.sources = tuple(sources)
        for src in self.sources:
            setattr(self, f'bn_{src.lower()}', BatchNorm(
                ch, 0.9 if src == 'SALICON' else 0.99))

    def select(self, source: str) -> BatchNorm:
        """The BatchNorm of ``source``."""
        if source not in self.sources:
            raise ValueError(f'unknown source {source!r}')
        return getattr(self, f'bn_{source.lower()}')

    def forward(self, x, source: str = 'DHF1K'):
        return self.select(source)(x)


def make_bn(ch: int, ds_bn: bool, sources: Sequence[str]) -> nn.Module:
    """A ``DomainBN`` or a plain :class:`BatchNorm` at flax momentum 0.99
    (names match the JAX tree)."""
    return DomainBN(ch, sources) if ds_bn else BatchNorm(ch)


def apply_bn(bn: nn.Module, x, source: str):
    if isinstance(bn, DomainBN):
        return bn(x, source)
    return bn(x)


def bn_act(bn: nn.Module, x, source: str, act=None, residual=None):
    """``residual + act(bn(x))``: the BatchNorm ``bn`` (a ``DomainBN``'s
    of ``source``), then ``act`` (None or :func:`relu6`), then the
    residual add where ``residual`` is given.

    On a CUDA tensor with no gradient being recorded (the clip programs
    run under ``inference_mode``) and ``bn`` in eval mode, one launch of
    the kernel ``kernels/bn_act.py``, which raises on an input it does not
    take; the residual is first laid out as ``x``.  A mesh shard's rows
    are normalised element by element like any others.  Otherwise the
    separate ops, as the modules ran them before the kernel (training,
    mesh training, the CPU)."""
    if isinstance(bn, DomainBN):
        bn = bn.select(source)
    if x.is_cuda and not torch.is_grad_enabled() and not bn.bn_train:
        if residual is not None:
            residual = residual.contiguous(
                memory_format=torch.channels_last
                if bn_act_kernel.layout_of(x) == 'nhwc'
                else torch.contiguous_format)
        return bn_act_kernel.bn_act(
            x, bn.running_mean, bn.running_var, bn.weight, bn.bias, _BN_EPS,
            relu6=act is relu6, residual=residual)
    y = bn(x) if act is None else act(bn(x))
    return y if residual is None else residual + y


class ConvBN(nn.Module):
    """3x3 conv (stride s) + BN + ReLU6."""

    def __init__(self, inp: int, features: int, stride: int = 1,
                 sources: Sequence[str] = DEFAULT_SOURCES,
                 ds_bn: bool = False):
        super().__init__()
        self.conv = nn.Conv2d(inp, features, 3, stride=stride, padding=1,
                              bias=False)
        self.bn = make_bn(features, ds_bn, sources)

    def forward(self, x, source: str = 'DHF1K'):
        return bn_act(self.bn, shard.conv2d(self.conv, x), source, relu6)


class Conv1x1BN(nn.Module):
    """1x1 conv + BN + ReLU6 (reference ``conv_1x1_bn``)."""

    def __init__(self, inp: int, features: int,
                 sources: Sequence[str] = DEFAULT_SOURCES,
                 ds_bn: bool = False):
        super().__init__()
        self.conv = nn.Conv2d(inp, features, 1, bias=False)
        self.bn = make_bn(features, ds_bn, sources)

    def forward(self, x, source: str = 'DHF1K'):
        return bn_act(self.bn, shard.conv2d(self.conv, x), source, relu6)


class InvertedResidual(nn.Module):
    """MobileNetV2 inverted residual with the reference's quirks.

    ``omit_stride``: the declared stride is recorded (the caller subsamples
    with ``x[..., ::2, ::2]`` afterwards) but the depthwise conv runs at
    stride 1.
    """

    def __init__(self, inp: int, oup: int, stride: int = 1,
                 expand_ratio: int = 6, omit_stride: bool = False,
                 no_res_connect: bool = False,
                 sources: Sequence[str] = DEFAULT_SOURCES,
                 ds_bn: bool = False):
        super().__init__()
        actual_stride = 1 if omit_stride else stride
        hidden = round(inp * expand_ratio)
        self.expand = expand_ratio != 1
        self.use_res_connect = (not no_res_connect and stride == 1
                                and inp == oup)
        if self.expand:
            self.pw = nn.Conv2d(inp, hidden, 1, bias=False)
            self.pw_bn = make_bn(hidden, ds_bn, sources)
        self.dw = nn.Conv2d(hidden, hidden, 3, stride=actual_stride,
                            padding=1, groups=hidden, bias=False)
        self.dw_bn = make_bn(hidden, ds_bn, sources)
        self.pw_linear = nn.Conv2d(hidden, oup, 1, bias=False)
        self.pw_linear_bn = make_bn(oup, ds_bn, sources)

    def forward(self, x, source: str = 'DHF1K'):
        h = x
        if self.expand:
            h = bn_act(self.pw_bn, shard.conv2d(self.pw, h), source, relu6)
        h = bn_act(self.dw_bn, shard.conv2d(self.dw, h), source, relu6)
        return bn_act(self.pw_linear_bn, shard.conv2d(self.pw_linear, h),
                      source, residual=x if self.use_res_connect else None)
