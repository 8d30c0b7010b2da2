"""Convolutional GRU (PyTorch, NCHW).

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
weight``), so ``convert`` maps every leaf by its path.

Training (``retargetvid_tpu/models/convgru.py:113-173``): with
``deterministic=False`` one keep mask per gate, shape (3, hidden), is drawn
once per sequence through ``models/dropout.py:keep_mask`` (recurrent drop
probability 0.2), shared over the batch and time and applied to ``h`` only,
scaled by ``1/keep``.  The cell's BatchNorms run once per time step, so in
train mode (``bn_train``) their statistics move at every step, as the JAX
scan carries ``batch_stats``.

Under mesh training the convolutions run through ``shard.conv2d`` and the
BatchNorms reduce over the mesh (``models/layers.py``); the recurrent mask
has no batch or row axis, so every rank draws the same one.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from retargetvid_tpu_torch.models import dropout
from retargetvid_tpu_torch.models.layers import (
    DEFAULT_SOURCES,
    apply_bn,
    make_bn,
    relu6,
)
from retargetvid_tpu_torch.parallel import shard

__all__ = ["ConvGRUCell", "ConvGRU"]

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
        h = relu6(apply_bn(self.sep_bn, shard.conv2d(self.conv_dw, x),
                           source))
        return shard.conv2d(self.conv_sep, h)


class ConvGRUCell(nn.Module):
    """One ConvGRU step; input (B, input_ch, H, W), hidden
    (B, hidden_ch, H, W)."""

    def __init__(self, input_ch: int, hidden_ch: int,
                 kernel_size: Tuple[int, int] = (3, 3),
                 gate_ksize: Tuple[int, int] = (3, 3),
                 sources: Sequence[str] = DEFAULT_SOURCES,
                 ds_bn: bool = True):
        super().__init__()

        def conv(in_ch, ksize):
            return _MobileConv(in_ch, hidden_ch, ksize, sources, ds_bn)

        self.w_r = conv(input_ch, gate_ksize)
        self.u_r = conv(hidden_ch, gate_ksize)
        self.w_z = conv(input_ch, gate_ksize)
        self.u_z = conv(hidden_ch, gate_ksize)
        self.w = conv(input_ch, kernel_size)
        self.u = conv(hidden_ch, gate_ksize)
        for name in ('norm_r_x', 'norm_r_h', 'norm_z_x', 'norm_z_h',
                     'norm_out_x', 'norm_out_h'):
            setattr(self, name, make_bn(hidden_ch, ds_bn, sources))
        for g in _GATES:
            for side in ('x', 'h'):
                setattr(self, f'a_{g}_{side}',
                        nn.Parameter(torch.ones(hidden_ch)))
        for g in _GATES:
            setattr(self, f'b_{g}', nn.Parameter(torch.zeros(hidden_ch)))

    def forward(self, x, h, source: str = 'DHF1K', drop_h=None):
        """``drop_h``: (3, C) recurrent keep masks (already scaled by
        ``1/keep``), one per gate, applied to ``h``."""
        def ch(p):                                  # (C,) -> (1, C, 1, 1)
            return p[None, :, None, None]

        def dh(i):
            return h if drop_h is None else h * ch(drop_h[i])

        def branch(conv, norm, scale, v):
            return apply_bn(getattr(self, norm),
                            getattr(self, conv)(v, source),
                            source) * ch(getattr(self, scale))

        r_x = branch('w_r', 'norm_r_x', 'a_r_x', x)
        r_h = branch('u_r', 'norm_r_h', 'a_r_h', dh(0))
        z_x = branch('w_z', 'norm_z_x', 'a_z_x', x)
        z_h = branch('u_z', 'norm_z_h', 'a_z_h', dh(1))
        h_x = branch('w', 'norm_out_x', 'a_h_x', x)
        h_h = branch('u', 'norm_out_h', 'a_h_h', dh(2))
        r = torch.sigmoid(r_x + r_h + ch(self.b_r))
        z = torch.sigmoid(z_x + z_h + ch(self.b_z))
        c = torch.tanh(h_x + r * h_h + ch(self.b_h))
        return (1.0 - z) * h + z * c


class ConvGRU(nn.Module):
    """Single-layer ConvGRU over (B, T, C, H, W) sequences.

    Returns (outputs (B, T, hidden_ch, H, W), final hidden
    (B, hidden_ch, H, W)); ``h0`` defaults to zeros.  ``drop_prob`` is
    JAX's fixed (x, h, out) triple; only the recurrent entry is used.
    """

    def __init__(self, input_ch: int, hidden_ch: int,
                 kernel_size: Tuple[int, int] = (3, 3),
                 gate_ksize: Tuple[int, int] = (3, 3),
                 drop_prob: Tuple[float, float, float] = (0.0, 0.2, 0.0),
                 sources: Sequence[str] = DEFAULT_SOURCES,
                 ds_bn: bool = True):
        super().__init__()
        self.hidden_ch = hidden_ch
        self.drop_prob = tuple(drop_prob)
        self.cell = ConvGRUCell(input_ch, hidden_ch, kernel_size, gate_ksize,
                                sources, ds_bn)

    def forward(self, xs, h0=None, source: str = 'DHF1K',
                deterministic: bool = True, generator=None):
        b, t, _, hh, ww = xs.shape
        h = h0 if h0 is not None else xs.new_zeros(
            (b, self.hidden_ch, hh, ww))
        drop_h = None
        if not deterministic and self.drop_prob[1] > 0:
            keep = 1.0 - self.drop_prob[1]
            drop_h = dropout.keep_mask((3, self.hidden_ch), keep, generator
                                       ).to(xs.device, xs.dtype) / keep
        outs = []
        for i in range(t):
            h = self.cell(xs[:, i], h, source, drop_h)
            outs.append(h)
        return torch.stack(outs, dim=1), h
