"""UNISAL (Droste et al., ECCV 2020), plain PyTorch, inference only.

MobileNetV2 backbone with 2x/4x skip taps, 16 learned Gaussian prior maps
at the coarsest scale, a Post-CNN inverted residual, the ConvGRU (bypassed
for static inputs) with its ``post_rnn`` 1x1 conv added to the features, a
two-stage decoder with skip concatenations, a per-source 1x1 adaptation
conv, a nearest resize to the input size, an edge-padded Gaussian smoothing
(its rank-8 factors as two 1-D convs), a bilinear resize to the target size
and a spatial log-softmax.  Parameter names are the repository port's.

(B, T, H, W, 3) in, (B, T, th, tw, 1) log-probabilities out, computed in
the parameters' dtype.
"""

from __future__ import annotations

import itertools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from portbench.reference.convgru import ConvGRU
from portbench.reference.layers import (
    DEFAULT_SOURCES,
    Conv1x1BN,
    InvertedResidual,
    apply_bn,
    make_bn,
)
from portbench.reference.mobilenet_v2 import MobileNetV2
from portbench.reference.resize import resize


def manual_gaussian_init() -> np.ndarray:
    """The 16 hand-placed Gaussians (reference ``model.py:323-331``)."""
    mus = (list(itertools.product([0.25, 0.5, 0.75], repeat=2)) +
           [(0.5, 0.25), (0.5, 0.5), (0.5, 0.75)] +
           [(0.25, 0.5), (0.5, 0.5), (0.75, 0.5)] +
           [(0.5, 0.5)])
    logstds = [(-1.5, -1.5)] * 9 + [(0.0, -1.5)] * 3 + \
              [(-1.5, 0.0)] * 3 + [(0.0, 0.0)]
    out = np.zeros((16, 2, 2), np.float32)
    for g in range(16):
        out[g, 0] = (mus[g][0], logstds[g][0])
        out[g, 1] = (mus[g][1], logstds[g][1])
    return out


def gaussian_prior_maps(gaussians, size_hw, scaling: float = 6.0):
    h, w = size_hw
    dev, dt = gaussians.device, gaussians.dtype
    gy = torch.linspace(0.0, 1.0, h, device=dev, dtype=dt)[None, :, None]
    gx = torch.linspace(0.0, 1.0, w, device=dev, dtype=dt)[None, None, :]
    mu_y = gaussians[:, 0, 0][:, None, None]
    std_y = torch.exp(gaussians[:, 0, 1])[:, None, None]
    mu_x = gaussians[:, 1, 0][:, None, None]
    std_x = torch.exp(gaussians[:, 1, 1])[:, None, None]
    m = torch.exp(-((gy - mu_y) / std_y) ** 2 / 2.0) * \
        torch.exp(-((gx - mu_x) / std_x) ** 2 / 2.0)
    return m * scaling


def smoothing_factors(ksize: int = 41, rank: int = 8):
    """Rank-``rank`` SVD factors of the normalised Gaussian smoothing
    kernel (mu 0.5, logstd -2 on a [0, 1] grid) as conv weights."""
    grid = np.linspace(0.0, 1.0, ksize)
    g1 = np.exp(-(((grid - 0.5) / np.exp(-2.0)) ** 2) / 2.0)
    k = np.outer(g1, g1)
    k = (k / k.sum()).astype(np.float32)
    u, s, vt = np.linalg.svd(k.astype(np.float64))
    kv = (u[:, :rank] * s[:rank]).T.reshape(rank, 1, ksize, 1)
    kh = vt[:rank, :].reshape(1, rank, 1, ksize)
    return kv.astype(np.float32), kh.astype(np.float32)


def spatial_log_softmax(x):
    shape = x.shape
    return F.log_softmax(x.reshape(shape[:-2] + (-1,)), dim=-1).reshape(shape)


class _SkipConnection(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, sources, ds_bn: bool = True):
        super().__init__()
        hidden = round(in_ch * 2)
        self.expansion = Conv1x1BN(in_ch, hidden, sources=sources,
                                   ds_bn=ds_bn)
        self.reduction_conv = nn.Conv2d(hidden, out_ch, 1, bias=True)
        self.reduction_bn = make_bn(out_ch, ds_bn, sources)

    def forward(self, x, source):
        return apply_bn(self.reduction_bn,
                        self.reduction_conv(self.expansion(x, source)),
                        source)


class UNISAL(nn.Module):
    """UNISAL with every domain switch on (the published model)."""

    def __init__(self, rnn_channels: int = 256, smoothing_ksize: int = 41,
                 smoothing_rank: int = 8, cnn_widen_factor: float = 1.0,
                 sources: Sequence[str] = DEFAULT_SOURCES):
        super().__init__()
        self.sources = tuple(sources)
        self.smoothing_ksize = smoothing_ksize
        self.cnn = MobileNetV2(widen_factor=cnn_widen_factor)
        self.skip_2x = _SkipConnection(self.cnn.feat_2x_channels, 128,
                                       sources)
        self.skip_4x = _SkipConnection(self.cnn.feat_4x_channels, 64,
                                       sources)
        g0 = torch.from_numpy(manual_gaussian_init())
        for s in self.sources:
            setattr(self, f'coarse_gaussians_{s.lower()}',
                    nn.Parameter(g0.clone()))
        self.post_cnn = InvertedResidual(self.cnn.out_channels + 16,
                                         rnn_channels, 1, 1, sources=sources)
        self.upsampling_2_inv_res = InvertedResidual(
            rnn_channels + 128, 128, 1, 2, sources=sources, ds_bn=True)
        self.post_upsampling_2_inv_res = InvertedResidual(
            128 + 64, 64, 1, 2, sources=sources, ds_bn=True)
        kv, kh = smoothing_factors(smoothing_ksize, smoothing_rank)
        for s in self.sources:
            setattr(self, f'adaptation_{s.lower()}',
                    nn.Conv2d(64, 1, 1, bias=True))
        for s in self.sources:
            setattr(self, f'smoothing_v_{s.lower()}',
                    nn.Parameter(torch.from_numpy(kv.copy())))
            setattr(self, f'smoothing_h_{s.lower()}',
                    nn.Parameter(torch.from_numpy(kh.copy())))
        self.rnn = ConvGRU(rnn_channels, rnn_channels, sources=sources)
        self.post_rnn = Conv1x1BN(rnn_channels, rnn_channels,
                                  sources=sources, ds_bn=True)

    def forward(self, x, target_size: Optional[Tuple[int, int]] = None,
                source: str = 'DHF1K', h0=None, static: bool = True):
        """(log-probabilities (B, T, th, tw, 1), the ConvGRU's last hidden
        state or None for a static input)."""
        b, t, h, w, c = x.shape
        target_size = target_size or (h, w)
        sfx = source.lower()
        dtype = self.cnn.features_0.conv.weight.dtype
        flat = x.reshape(b * t, h, w, c).permute(0, 3, 1, 2).to(dtype)
        feat_1x, feat_2x, feat_4x = self.cnn(flat)
        feat_2x = self.skip_2x(feat_2x, source)
        feat_4x = self.skip_4x(feat_4x, source)
        h32 = feat_1x.shape[2]
        priors = gaussian_prior_maps(getattr(self, f'coarse_gaussians_{sfx}'),
                                     (h32, feat_1x.shape[3]))
        priors = priors[None].expand(feat_1x.shape[0], -1, -1, -1)
        up = self.post_cnn(torch.cat([feat_1x, priors.to(dtype)], dim=1),
                           source)
        hidden = None
        if not static:
            seq = up.reshape(b, t, *up.shape[1:])
            rnn_out, hidden = self.rnn(seq, h0=h0, source=source)
            up = up + self.post_rnn(rnn_out.flatten(0, 1), source)
        up = resize(up, (2 * h32, up.shape[3] * 2), 'linear',
                    channels_last=False).to(dtype)
        up = self.upsampling_2_inv_res(torch.cat([up, feat_2x], dim=1),
                                       source)
        up = resize(up, (4 * h32, up.shape[3] * 2), 'linear',
                    channels_last=False).to(dtype)
        up = self.post_upsampling_2_inv_res(torch.cat([up, feat_4x], dim=1),
                                            source)
        up = getattr(self, f'adaptation_{sfx}')(up)
        up = resize(up, (h, w), 'nearest', channels_last=False).to(dtype)
        pad = self.smoothing_ksize // 2
        up = F.pad(up, (pad, pad, pad, pad), mode='replicate')
        up = F.conv2d(up, getattr(self, f'smoothing_v_{sfx}'))
        up = F.conv2d(up, getattr(self, f'smoothing_h_{sfx}'))
        up = spatial_log_softmax(resize(up, target_size, 'linear',
                                        channels_last=False))
        return up.permute(0, 2, 3, 1).reshape(b, t, *up.shape[2:], 1), hidden
