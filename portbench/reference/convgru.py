"""Convolutional GRU of the reference UNISAL (plain PyTorch, NCHW,
inference only).

UNISAL's ConvGRU (``unisal/models/cgru.py`` as UNISAL configures it): six
depthwise-separable convolutions, per-branch domain BatchNorm with free
affine scales ``a_*`` and gate biases ``b_*``:

    r = sigmoid(a_r_x BN(w_r x) + a_r_h BN(u_r h) + b_r)
    z = sigmoid(a_z_x BN(w_z x) + a_z_h BN(u_z h) + b_z)
    c = tanh  (a_h_x BN(w   x) + r * a_h_h BN(u  h) + b_h)
    h' = (1 - z) h + z c
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from portbench.reference.layers import DEFAULT_SOURCES, apply_bn, make_bn, relu6

_GATES = ('r', 'z', 'h')


class _MobileConv(nn.Module):
    """Depthwise k x k + BN + ReLU6 + pointwise 1x1 (no biases)."""

    def __init__(self, in_ch: int, out_ch: int,
                 ksize: Tuple[int, int] = (3, 3),
                 sources: Sequence[str] = DEFAULT_SOURCES,
                 ds_bn: bool = True):
        super().__init__()
        self.conv_dw = nn.Conv2d(in_ch, in_ch, ksize,
                                 padding=tuple(k // 2 for k in ksize),
                                 groups=in_ch, bias=False)
        self.sep_bn = make_bn(in_ch, ds_bn, sources)
        self.conv_sep = nn.Conv2d(in_ch, out_ch, 1, bias=False)

    def forward(self, x, source: str = 'DHF1K'):
        return self.conv_sep(relu6(apply_bn(self.sep_bn, self.conv_dw(x),
                                            source)))


class ConvGRUCell(nn.Module):
    def __init__(self, input_ch: int, hidden_ch: int,
                 sources: Sequence[str] = DEFAULT_SOURCES,
                 ds_bn: bool = True):
        super().__init__()

        def conv(in_ch):
            return _MobileConv(in_ch, hidden_ch, (3, 3), sources, ds_bn)

        self.w_r = conv(input_ch)
        self.u_r = conv(hidden_ch)
        self.w_z = conv(input_ch)
        self.u_z = conv(hidden_ch)
        self.w = conv(input_ch)
        self.u = conv(hidden_ch)
        for name in ('norm_r_x', 'norm_r_h', 'norm_z_x', 'norm_z_h',
                     'norm_out_x', 'norm_out_h'):
            setattr(self, name, make_bn(hidden_ch, ds_bn, sources))
        for g in _GATES:
            for side in ('x', 'h'):
                setattr(self, f'a_{g}_{side}',
                        nn.Parameter(torch.ones(hidden_ch)))
        for g in _GATES:
            setattr(self, f'b_{g}', nn.Parameter(torch.zeros(hidden_ch)))

    def forward(self, x, h, source: str = 'DHF1K'):
        def ch(p):
            return p[None, :, None, None]

        def branch(conv, norm, scale, v):
            return apply_bn(getattr(self, norm),
                            getattr(self, conv)(v, source),
                            source) * ch(getattr(self, scale))

        r = torch.sigmoid(branch('w_r', 'norm_r_x', 'a_r_x', x)
                          + branch('u_r', 'norm_r_h', 'a_r_h', h)
                          + ch(self.b_r))
        z = torch.sigmoid(branch('w_z', 'norm_z_x', 'a_z_x', x)
                          + branch('u_z', 'norm_z_h', 'a_z_h', h)
                          + ch(self.b_z))
        c = torch.tanh(branch('w', 'norm_out_x', 'a_h_x', x)
                       + r * branch('u', 'norm_out_h', 'a_h_h', h)
                       + ch(self.b_h))
        return (1.0 - z) * h + z * c


class ConvGRU(nn.Module):
    """Over (B, T, C, H, W): (outputs (B, T, hidden, H, W), final h)."""

    def __init__(self, input_ch: int, hidden_ch: int,
                 sources: Sequence[str] = DEFAULT_SOURCES,
                 ds_bn: bool = True):
        super().__init__()
        self.hidden_ch = hidden_ch
        self.cell = ConvGRUCell(input_ch, hidden_ch, sources, ds_bn)

    def forward(self, xs, h0=None, source: str = 'DHF1K'):
        b, t, _, hh, ww = xs.shape
        h = h0 if h0 is not None else xs.new_zeros(
            (b, self.hidden_ch, hh, ww))
        outs = []
        for i in range(t):
            h = self.cell(xs[:, i], h, source)
            outs.append(h)
        return torch.stack(outs, dim=1), h
