"""UNISAL saliency model (PyTorch, NCHW inside).

Port of ``retargetvid_tpu/models/unisal.py:UNISAL``: MobileNetV2 backbone
with 2x/4x skip taps, 16 learned Gaussian prior maps concatenated at the
coarsest scale, a Post-CNN inverted residual, the ConvGRU (bypassed for
static inputs, the crop pipeline's mode) with its ``post_rnn`` 1x1 conv, a
two-stage decoder with skip concatenations, a per-source 1x1 adaptation
conv, nearest resize to the input size, an edge-padded Gaussian smoothing
conv (its stored rank-r factors as two 1-D convs, or with
``smoothing_rank=None`` the full k x k kernel), a bilinear resize to the
target size and a spatial log-softmax.  Under inference on a CUDA device
the nearest resize, the pad and the factored smoothing are one launch of
``kernels/smooth.py`` (see :func:`smoothing_on_kernel`).

Training knobs (``retargetvid_tpu/models/unisal.py:163-183``):
``drop_probs`` (the skip connections' dropout, live with
``deterministic=False``), ``bn_train`` (flax train-mode BatchNorm, see
``models/layers.py``; the backbone's BatchNorm stays in eval mode, as the
JAX ``MobileNetV2`` takes no ``bn_train``, so ``cnn_eval`` is stored and
in effect always true), and the domain switches ``ds_bn``,
``ds_adaptation``, ``ds_smoothing`` and ``ds_gaussians``: off, the module
is shared by all sources and its name loses the ``_<source>`` suffix.
Every dropout mask is drawn through ``models/dropout.py:keep_mask`` from
the ``generator`` passed to ``forward``.

The public call keeps the JAX layout: (B, T, H, W, 3) in,
(B, T, th, tw, 1) log-probabilities out; :meth:`UNISAL.forward_with_hidden`
also returns the ConvGRU's final hidden state (B, C, h, w), NCHW.  The
network computes in the dtype of its parameters; an input of another dtype
is cast to it (the JAX model's float32 parameters likewise promote a bf16
input to float32).

Under mesh training (``parallel/shard.py``) ``x`` is this rank's block:
its samples of the global batch and its rows of the frames.  The dropout
masks are drawn at the global batch's shape and sliced, the priors are
computed at the global height and sliced, the resizes, the smoothing's
replicate padding and the log-softmax reach across the row shards, and the
output is this rank's block of the global log-probabilities.
"""

from __future__ import annotations

import contextlib
import itertools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from retargetvid_tpu_torch.kernels import smooth
from retargetvid_tpu_torch.models import dropout
from retargetvid_tpu_torch.models.convgru import ConvGRU
from retargetvid_tpu_torch.models.layers import (
    DEFAULT_SOURCES,
    Conv1x1BN,
    InvertedResidual,
    bn_act,
    make_bn,
    set_bn_train,
)
from retargetvid_tpu_torch.models.mobilenet_v2 import MobileNetV2
from retargetvid_tpu_torch.ops.resize import resize
from retargetvid_tpu_torch.parallel import shard

__all__ = ["UNISAL", "manual_gaussian_init", "gaussian_prior_maps",
           "spatial_log_softmax", "smoothing_kernel_init",
           "factorize_smoothing_kernel", "smoothing_on_kernel"]


def manual_gaussian_init() -> np.ndarray:
    """The 16 hand-placed Gaussians (reference ``model.py:323-331``):
    (16, 2, 2) -- [gaussian, y/x, mu/logstd]."""
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


def gaussian_prior_maps(gaussians: torch.Tensor, size_hw: Tuple[int, int],
                        scaling: float = 6.0) -> torch.Tensor:
    """(G, 2, 2) Gaussian parameters -> (G, H, W) prior maps."""
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


def smoothing_kernel_init(ksize: int = 41) -> np.ndarray:
    """Normalized Gaussian smoothing kernel (reference ``model.py:264-272``),
    mu=0.5, logstd=-2 on a [0, 1] grid; (k, k)."""
    grid = np.linspace(0.0, 1.0, ksize)
    g1 = np.exp(-(((grid - 0.5) / np.exp(-2.0)) ** 2) / 2.0)
    k = np.outer(g1, g1)
    return (k / k.sum()).astype(np.float32)


def factorize_smoothing_kernel(kernel2d: np.ndarray, rank: int):
    """SVD factors of a (k, k) kernel as conv weights (OIHW):
    ``kv`` (r, 1, k, 1) and ``kh`` (1, r, 1, k), so that the vertical then
    the horizontal conv equal the 2-D conv up to ``sigma_{r+1}/sigma_1``."""
    k = kernel2d.shape[0]
    u, s, vt = np.linalg.svd(kernel2d.astype(np.float64))
    r = min(rank, k)
    kv = (u[:, :r] * s[:r]).T.reshape(r, 1, k, 1).astype(np.float32)
    kh = vt[:r, :].reshape(1, r, 1, k).astype(np.float32)
    trunc = float(s[r] / s[0]) if r < k else 0.0
    return kv, kh, trunc


def smoothing_on_kernel(x: torch.Tensor, smoothing_rank) -> bool:
    """Whether the smoothing tail of the adaptation map ``x`` runs as the
    CUDA kernel ``kernels/smooth.py``: on a CUDA tensor with no gradient
    being recorded (the programs run under ``inference_mode``), outside
    mesh training, for a model with factored smoothing (``smoothing_rank``
    set).  The kernel's wrapper raises on a map or factors it does not
    take.  Otherwise the separate ops: training (the factors' gradients),
    mesh training (the pad reaches across the row shards), the full k x k
    kernel, the CPU."""
    return (x.is_cuda and not torch.is_grad_enabled()
            and shard.current() is None and bool(smoothing_rank))


def spatial_log_softmax(x: torch.Tensor) -> torch.Tensor:
    """Log-softmax over the two trailing (spatial) dims."""
    shape = x.shape
    return F.log_softmax(x.reshape(shape[:-2] + (-1,)), dim=-1).reshape(shape)


class _SkipConnection(nn.Module):
    """expansion (1x1 conv + BN + ReLU6) -> dropout -> reduction (1x1
    conv + BN); the dropout mask is one per (frame, channel)."""

    def __init__(self, in_ch: int, out_ch: int, expand_ratio: int = 2,
                 drop_prob: float = 0.6,
                 sources: Sequence[str] = DEFAULT_SOURCES,
                 ds_bn: bool = True):
        super().__init__()
        hidden = round(in_ch * expand_ratio)
        self.drop_prob = drop_prob
        self.expansion = Conv1x1BN(in_ch, hidden, sources=sources,
                                   ds_bn=ds_bn)
        self.reduction_conv = nn.Conv2d(hidden, out_ch, 1, bias=True)
        self.reduction_bn = make_bn(out_ch, ds_bn, sources)

    def forward(self, x, source, deterministic: bool = True,
                generator=None):
        x = self.expansion(x, source)
        if not deterministic:
            n, rows = x.shape[0], None
            sharded = shard.current()
            if sharded is not None:
                n, rows = sharded.batch_rows(n)
            x = dropout.dropout(x, self.drop_prob, (n, x.shape[1], 1, 1),
                                generator, rows)
        return bn_act(self.reduction_bn,
                      shard.conv2d(self.reduction_conv, x), source)


class UNISAL(nn.Module):
    """UNISAL; see the module docstring for the layout and the knobs.

    ``with_rnn`` builds the ConvGRU; ``bypass_rnn`` skips it for static
    inputs; ``res_rnn`` adds its ``post_rnn`` output to the features
    instead of replacing them.
    """

    def __init__(self, rnn_input_channels: int = 256,
                 rnn_hidden_channels: int = 256,
                 cnn_widen_factor: float = 1.0,
                 cnn_last_channel: Optional[int] = 1280,
                 bypass_rnn: bool = True, res_rnn: bool = True,
                 n_gaussians: int = 16, smoothing_ksize: int = 41,
                 smoothing_rank: Optional[int] = 8,
                 drop_probs: Tuple[float, float, float] = (0.0, 0.6, 0.6),
                 sources: Sequence[str] = DEFAULT_SOURCES,
                 ds_bn: bool = True, ds_adaptation: bool = True,
                 ds_smoothing: bool = True, ds_gaussians: bool = True,
                 with_rnn: bool = True, bn_train: bool = False,
                 cnn_eval: bool = True):
        super().__init__()
        self.sources = tuple(sources)
        self.bypass_rnn = bypass_rnn
        self.res_rnn = res_rnn
        self.with_rnn = with_rnn
        self.n_gaussians = n_gaussians
        self.smoothing_ksize = smoothing_ksize
        self.smoothing_rank = smoothing_rank
        self.drop_probs = tuple(drop_probs)
        self.ds_bn = ds_bn
        self.ds_adaptation = ds_adaptation
        self.ds_smoothing = ds_smoothing
        self.ds_gaussians = ds_gaussians
        #: Stored for the config; the backbone's BatchNorm is in eval mode
        #: whatever ``bn_train`` says (the JAX ``MobileNetV2`` takes no
        #: ``bn_train``), so the flag is in effect always true.
        self.cnn_eval = cnn_eval
        self.cnn = MobileNetV2(widen_factor=cnn_widen_factor,
                               last_channel=cnn_last_channel)
        self.skip_2x = _SkipConnection(self.cnn.feat_2x_channels, 128, 2,
                                       self.drop_probs[1], sources, ds_bn)
        self.skip_4x = _SkipConnection(self.cnn.feat_4x_channels, 64, 2,
                                       self.drop_probs[2], sources, ds_bn)
        feat_ch = self.cnn.out_channels
        if n_gaussians > 0:
            g0 = torch.from_numpy(manual_gaussian_init())
            for suf in self._suffixes(ds_gaussians):
                setattr(self, f'coarse_gaussians{suf}',
                        nn.Parameter(g0.clone()))
            feat_ch += g0.shape[0]
        self.post_cnn = InvertedResidual(feat_ch, rnn_input_channels, 1, 1,
                                         sources=sources, ds_bn=False)
        self.upsampling_2_inv_res = InvertedResidual(
            rnn_input_channels + 128, 128, 1, 2, sources=sources,
            ds_bn=ds_bn)
        self.post_upsampling_2_inv_res = InvertedResidual(
            128 + 64, 64, 1, 2, sources=sources, ds_bn=ds_bn)
        for suf in self._suffixes(ds_adaptation):
            setattr(self, f'adaptation{suf}', nn.Conv2d(64, 1, 1, bias=True))
        kernel = smoothing_kernel_init(smoothing_ksize)
        if smoothing_rank:
            kv, kh, _ = factorize_smoothing_kernel(kernel, smoothing_rank)
        for suf in self._suffixes(ds_smoothing):
            if smoothing_rank:
                setattr(self, f'smoothing_v{suf}',
                        nn.Parameter(torch.from_numpy(kv.copy())))
                setattr(self, f'smoothing_h{suf}',
                        nn.Parameter(torch.from_numpy(kh.copy())))
            else:
                setattr(self, f'smoothing{suf}', nn.Parameter(
                    torch.from_numpy(kernel.copy())[None, None]))
        # Registered last: ``models/init.py:seeded_init_`` draws conv
        # weights in ``modules()`` order, so every module above keeps the
        # weights it had without the ConvGRU.
        if with_rnn:
            self.rnn = ConvGRU(rnn_input_channels, rnn_hidden_channels,
                               sources=sources, ds_bn=ds_bn)
            self.post_rnn = Conv1x1BN(rnn_hidden_channels, rnn_input_channels,
                                      sources=sources, ds_bn=ds_bn)
        self.set_bn_train(bn_train)

    def _suffixes(self, flag: bool):
        return ([f'_{s.lower()}' for s in self.sources] if flag else [''])

    @staticmethod
    def _suffix(flag: bool, source: str) -> str:
        return f'_{source.lower()}' if flag else ''

    def set_bn_train(self, flag: bool) -> None:
        """Train-mode BatchNorm everywhere but in the backbone."""
        self.bn_train = bool(flag)
        for name, child in self.named_children():
            if name != 'cnn':
                set_bn_train(child, self.bn_train)

    @contextlib.contextmanager
    def bn_mode(self, flag: bool):
        """``bn_train`` set to ``flag`` inside the block, restored after."""
        saved = self.bn_train
        self.set_bn_train(flag)
        try:
            yield self
        finally:
            self.set_bn_train(saved)

    @staticmethod
    def _level(h: int) -> None:
        sharded = shard.current()
        if sharded is not None:
            sharded.at(h)

    @staticmethod
    def _resize(x, out_hw, method: str):
        """``resize`` of NCHW ``x``; under mesh training across the row
        shards, from the current level to the one of height
        ``out_hw[0]``."""
        sharded = shard.current()
        if sharded is None:
            return resize(x, out_hw, method, channels_last=False)
        return sharded.resize(x, out_hw, method)

    def forward(self, x, target_size: Optional[Tuple[int, int]] = None,
                source: str = 'DHF1K', h0=None,
                static: Optional[bool] = None,
                deterministic: bool = True, generator=None):
        """Log-probabilities (B, T, th, tw, 1); see
        :meth:`forward_with_hidden`."""
        return self.forward_with_hidden(x, target_size, source, h0, static,
                                        deterministic, generator)[0]

    def forward_with_hidden(self, x,
                            target_size: Optional[Tuple[int, int]] = None,
                            source: str = 'DHF1K', h0=None,
                            static: Optional[bool] = None,
                            deterministic: bool = True, generator=None):
        """(log-probabilities (B, T, th, tw, 1), the ConvGRU's final hidden
        state (B, C, h, w) or None where it did not run).

        ``static=None`` means ``T == 1`` or a SALICON-only model; ``h0``
        (B, C, h, w) starts the ConvGRU (zeros by default).  With
        ``deterministic=False`` the dropout masks are drawn from
        ``generator``."""
        if source not in self.sources:
            raise ValueError(f'unknown source {source!r}')
        b, t, h, w, c = x.shape
        sharded = shard.current()
        if sharded is not None:
            h = sharded.at(sharded.height).level    # the global height
        if target_size is None:
            target_size = (h, w)
        if static is None:
            static = t == 1 or self.sources == ('SALICON',)
        dtype = self.cnn.features_0.conv.weight.dtype
        flat = x.reshape(b * t, x.shape[2], w, c).permute(0, 3, 1, 2).to(
            dtype)
        feat_1x, feat_2x, feat_4x = self.cnn(flat)
        # Global heights of the 1/8, 1/16 and 1/32 levels.
        h8 = shard.halve(shard.halve(shard.halve(h)))
        h16, h32 = shard.halve(h8), shard.halve(shard.halve(h8))
        self._level(h16)
        feat_2x = self.skip_2x(feat_2x, source, deterministic, generator)
        self._level(h8)
        feat_4x = self.skip_4x(feat_4x, source, deterministic, generator)
        self._level(h32)

        if self.n_gaussians > 0:
            gsuf = self._suffix(self.ds_gaussians, source)
            priors = gaussian_prior_maps(
                getattr(self, f'coarse_gaussians{gsuf}'),
                (h32, feat_1x.shape[3]))
            if sharded is not None:
                priors = sharded.row_slice(priors)
            priors = priors[None].expand(feat_1x.shape[0], -1, -1, -1)
            feat_1x = torch.cat([feat_1x, priors.to(dtype)], dim=1)
        up = self.post_cnn(feat_1x, source)

        # The ConvGRU, bypassed for static inputs (reference
        # ``model.py:457-460``).
        hidden = None
        if self.with_rnn and not (static and self.bypass_rnn):
            seq = up.reshape(b, t, *up.shape[1:])
            rnn_out, hidden = self.rnn(seq, h0=h0, source=source,
                                       deterministic=deterministic,
                                       generator=generator)
            rnn_out = self.post_rnn(rnn_out.flatten(0, 1), source)
            up = up + rnn_out if self.res_rnn else rnn_out

        # Decoder.
        up = self._resize(up, (2 * h32, up.shape[3] * 2), 'linear').to(dtype)
        up = torch.cat([up, feat_2x], dim=1)
        up = self.upsampling_2_inv_res(up, source)
        up = self._resize(up, (4 * h32, up.shape[3] * 2), 'linear').to(dtype)
        up = torch.cat([up, feat_4x], dim=1)
        up = self.post_upsampling_2_inv_res(up, source)
        up = shard.conv2d(getattr(self, 'adaptation' + self._suffix(
            self.ds_adaptation, source)), up)

        # Nearest resize to the input size, edge pad, smoothing: one
        # kernel launch where ``smoothing_on_kernel``, else the ops.
        ssuf = self._suffix(self.ds_smoothing, source)
        kv = getattr(self, f'smoothing_v{ssuf}', None)   # None: k x k
        kh = getattr(self, f'smoothing_h{ssuf}', None)
        if smoothing_on_kernel(up, self.smoothing_rank):
            up = smooth.saliency_smooth(up.contiguous(), kv, kh, (h, w))
        else:
            up = self._resize(up, (h, w), 'nearest').to(dtype)
            pad = self.smoothing_ksize // 2
            if sharded is None:
                up = F.pad(up, (pad, pad, pad, pad), mode='replicate')
            else:
                up = sharded.replicate_pad(up, pad)
            if self.smoothing_rank:
                up = F.conv2d(up, kv)
                up = F.conv2d(up, kh)
            else:
                up = F.conv2d(up, getattr(self, f'smoothing{ssuf}'))

        up = self._resize(up, target_size, 'linear')
        if sharded is not None and sharded.split:
            up = sharded.log_softmax(up)
        else:
            up = spatial_log_softmax(up)                  # (BT, 1, th, tw)
        return up.permute(0, 2, 3, 1).reshape(b, t, *up.shape[2:], 1), hidden
