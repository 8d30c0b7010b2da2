"""Building blocks of the reference saliency model (plain PyTorch, NCHW,
inference only).

A frozen copy of the blocks of UNISAL as the repository's port builds them
(``ConvBN``, ``Conv1x1BN``, the MobileNetV2 ``InvertedResidual`` with the
reference's ``omit_stride`` quirk, per-source ``DomainBN``), cut to what
inference needs: BatchNorm always normalises with its running statistics,
and nothing is sharded or dropped out.  Submodule names are the port's, so
one state dict fills both.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

DEFAULT_SOURCES = ('DHF1K', 'Hollywood', 'UCFSports', 'SALICON')
_BN_EPS = 1e-5


def relu6(x):
    return torch.clamp(x, 0.0, 6.0)


class BatchNorm(nn.BatchNorm2d):
    """Eval-mode BatchNorm (running statistics, eps 1e-5)."""

    def __init__(self, ch: int):
        super().__init__(ch, eps=_BN_EPS)

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, training=False,
                            eps=_BN_EPS)


class DomainBN(nn.Module):
    """One BatchNorm per source, ``bn_<source>``."""

    def __init__(self, ch: int, sources: Sequence[str] = DEFAULT_SOURCES):
        super().__init__()
        self.sources = tuple(sources)
        for src in self.sources:
            setattr(self, f'bn_{src.lower()}', BatchNorm(ch))

    def forward(self, x, source: str = 'DHF1K'):
        if source not in self.sources:
            raise ValueError(f'unknown source {source!r}')
        return getattr(self, f'bn_{source.lower()}')(x)


def make_bn(ch: int, ds_bn: bool, sources: Sequence[str]) -> nn.Module:
    return DomainBN(ch, sources) if ds_bn else BatchNorm(ch)


def apply_bn(bn: nn.Module, x, source: str):
    return bn(x, source) if isinstance(bn, DomainBN) else bn(x)


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
        return relu6(apply_bn(self.bn, self.conv(x), source))


class Conv1x1BN(nn.Module):
    """1x1 conv + BN + ReLU6."""

    def __init__(self, inp: int, features: int,
                 sources: Sequence[str] = DEFAULT_SOURCES,
                 ds_bn: bool = False):
        super().__init__()
        self.conv = nn.Conv2d(inp, features, 1, bias=False)
        self.bn = make_bn(features, ds_bn, sources)

    def forward(self, x, source: str = 'DHF1K'):
        return relu6(apply_bn(self.bn, self.conv(x), source))


class InvertedResidual(nn.Module):
    """MobileNetV2 inverted residual; with ``omit_stride`` the depthwise
    conv runs at stride 1 and the caller subsamples afterwards."""

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
            h = relu6(apply_bn(self.pw_bn, self.pw(h), source))
        h = relu6(apply_bn(self.dw_bn, self.dw(h), source))
        h = apply_bn(self.pw_linear_bn, self.pw_linear(h), source)
        return x + h if self.use_res_connect else h
