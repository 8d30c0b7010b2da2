"""Convolutional GRU (PyTorch, NCHW), inference.

Port of ``retargetvid_tpu/models/convgru.py`` (reference
``unisal/models/cgru.py:16-375`` as UNISAL configures it): six mobile
depthwise-separable convolutions (w_r, u_r, w_z, u_z, w, u), per-branch
domain-specific BatchNorm with free affine scales (a_*) and shared gate
biases (b_r, b_z, b_h):

    r = sigmoid(a_r_x BN(w_r x) + a_r_h BN(u_r h) + b_r)
    z = sigmoid(a_z_x BN(w_z x) + a_z_h BN(u_z h) + b_z)
    c = tanh  (a_h_x BN(w   x) + r * a_h_h BN(u  h) + b_h)
    h' = (1 - z) h + z c

Time is a Python loop, as in the reference.  Submodule names follow the
JAX tree (``rnn/cell/w_r/conv_dw/kernel`` -> ``rnn.cell.w_r.conv_dw.
weight``), so ``convert`` maps every leaf by its path.  The recurrent
dropout masks and train-mode BatchNorm are training features and are not
ported.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from retargetvid_tpu_torch.models.layers import DEFAULT_SOURCES, DomainBN, relu6

__all__ = ["ConvGRUCell", "ConvGRU"]

_GATES = ('r', 'z', 'h')


class _MobileConv(nn.Module):
    """Depthwise k x k + BN + ReLU6 + pointwise 1x1 (no biases)."""

    def __init__(self, in_ch: int, out_ch: int,
                 ksize: Tuple[int, int] = (3, 3),
                 sources: Sequence[str] = DEFAULT_SOURCES):
        super().__init__()
        self.conv_dw = nn.Conv2d(in_ch, in_ch, ksize,
                                 padding=tuple(k // 2 for k in ksize),
                                 groups=in_ch, bias=False)
        self.sep_bn = DomainBN(in_ch, sources)
        self.conv_sep = nn.Conv2d(in_ch, out_ch, 1, bias=False)

    def forward(self, x, source: str = 'DHF1K'):
        return self.conv_sep(relu6(self.sep_bn(self.conv_dw(x), source)))


class ConvGRUCell(nn.Module):
    """One ConvGRU step; input (B, input_ch, H, W), hidden
    (B, hidden_ch, H, W)."""

    def __init__(self, input_ch: int, hidden_ch: int,
                 kernel_size: Tuple[int, int] = (3, 3),
                 gate_ksize: Tuple[int, int] = (3, 3),
                 sources: Sequence[str] = DEFAULT_SOURCES):
        super().__init__()
        self.w_r = _MobileConv(input_ch, hidden_ch, gate_ksize, sources)
        self.u_r = _MobileConv(hidden_ch, hidden_ch, gate_ksize, sources)
        self.w_z = _MobileConv(input_ch, hidden_ch, gate_ksize, sources)
        self.u_z = _MobileConv(hidden_ch, hidden_ch, gate_ksize, sources)
        self.w = _MobileConv(input_ch, hidden_ch, kernel_size, sources)
        self.u = _MobileConv(hidden_ch, hidden_ch, gate_ksize, sources)
        for name in ('norm_r_x', 'norm_r_h', 'norm_z_x', 'norm_z_h',
                     'norm_out_x', 'norm_out_h'):
            setattr(self, name, DomainBN(hidden_ch, sources))
        for g in _GATES:
            for side in ('x', 'h'):
                setattr(self, f'a_{g}_{side}',
                        nn.Parameter(torch.ones(hidden_ch)))
        for g in _GATES:
            setattr(self, f'b_{g}', nn.Parameter(torch.zeros(hidden_ch)))

    def forward(self, x, h, source: str = 'DHF1K'):
        def ch(p):                                  # (C,) -> (1, C, 1, 1)
            return p[None, :, None, None]

        def branch(conv, norm, scale, v):
            return getattr(self, norm)(getattr(self, conv)(v, source),
                                       source) * ch(getattr(self, scale))

        r_x = branch('w_r', 'norm_r_x', 'a_r_x', x)
        r_h = branch('u_r', 'norm_r_h', 'a_r_h', h)
        z_x = branch('w_z', 'norm_z_x', 'a_z_x', x)
        z_h = branch('u_z', 'norm_z_h', 'a_z_h', h)
        h_x = branch('w', 'norm_out_x', 'a_h_x', x)
        h_h = branch('u', 'norm_out_h', 'a_h_h', h)
        r = torch.sigmoid(r_x + r_h + ch(self.b_r))
        z = torch.sigmoid(z_x + z_h + ch(self.b_z))
        c = torch.tanh(h_x + r * h_h + ch(self.b_h))
        return (1.0 - z) * h + z * c


class ConvGRU(nn.Module):
    """Single-layer ConvGRU over (B, T, C, H, W) sequences.

    Returns (outputs (B, T, hidden_ch, H, W), final hidden
    (B, hidden_ch, H, W)); ``h0`` defaults to zeros.
    """

    def __init__(self, input_ch: int, hidden_ch: int,
                 kernel_size: Tuple[int, int] = (3, 3),
                 gate_ksize: Tuple[int, int] = (3, 3),
                 sources: Sequence[str] = DEFAULT_SOURCES):
        super().__init__()
        self.hidden_ch = hidden_ch
        self.cell = ConvGRUCell(input_ch, hidden_ch, kernel_size, gate_ksize,
                                sources)

    def forward(self, xs, h0=None, source: str = 'DHF1K'):
        b, t, _, hh, ww = xs.shape
        h = h0 if h0 is not None else xs.new_zeros(
            (b, self.hidden_ch, hh, ww))
        outs = []
        for i in range(t):
            h = self.cell(xs[:, i], h, source)
            outs.append(h)
        return torch.stack(outs, dim=1), h
