"""TransNet V2 shot-boundary detector (PyTorch, NCDHW).

Souček and Lokoč, "TransNet V2: An effective deep network architecture for
fast shot transition detection" (arXiv:2008.04838); the module follows the
authors' PyTorch file (github.com/soCzech/TransNetV2,
``inference-pytorch/transnetv2_pytorch.py``) and keeps its module and
parameter names, so a state dict saved from the published module loads
as it is (:meth:`TransNetV2.from_state_dict`).

uint8 frames (B, T, 27, 48, 3) scaled by 1/255 pass through L=3
``StackedDDCNNV2`` stacks of S=2 ``DilatedDCNNV2`` cells (F, 2F, 4F
filters).  A cell runs four separable (2+1)D branches without bias -- a
(1, 3, 3) Conv3d to 2F channels, then a (3, 1, 1) Conv3d to F channels at
temporal dilation 1, 2, 4 or 8 -- concatenates them to 4F channels and
applies ``BatchNorm3d(4F, eps=1e-3)``, with a ReLU after every cell but a
stack's last.  A stack then applies ReLU, adds its first cell's output and
average-pools (1, 2, 2).  Two banded branches look 50 frames each way:

- frame similarity: the spatial means of the three stacks' outputs
  (7 x 4F channels), ``Linear(.., 128)``, L2-normalised, a T x T ``bmm``,
  each frame's 101-wide band of it (zero past the forward's own frames),
  ``Linear(101, 128)`` and ReLU;
- colour histograms: 512-bin RGB histograms of the uint8 frames (3 bits a
  channel, ``scatter_add_``), L2-normalised, the same ``bmm`` and band,
  ``Linear(101, 128)`` and ReLU.

The head concatenates [histograms, similarity, the last stack flattened
in (h, w, c) order], ``fc1`` (D) with ReLU, then ``cls_layer1`` (one-hot)
and ``cls_layer2`` (many-hot).  :meth:`TransNetV2.forward` returns
``sigmoid(one_hot)`` in float32, V1's interface; :meth:`TransNetV2.logits`
returns both heads.  A cut is a probability above :attr:`threshold`, the
published 0.5.  Dropout is an identity at inference and is left out.

Precision: the module computes in its parameters' dtype (``.to(bf16)``,
as ``OneShotClipProgram`` casts it): the stacks with their BatchNorm, the
frame-similarity branch and every dense layer.  The histogram counts are
int32 and their normalisation, ``bmm`` and band run in float32, as the
published file computes them; the band is cast to the dtype of the
branch's ``fc``.  The sigmoid runs in float32.

Spans (``utils.timing``): ``transnet.stacks`` around the three stacks,
``transnet.similarity`` around both banded branches.  The band is a
strided view of the zero-padded T x (T + 100) similarity matrix, the
values of the published gather.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from retargetvid_tpu_torch.utils import timing

__all__ = ["TransNetV2", "StackedDDCNNV2", "DilatedDCNNV2",
           "Conv3DConfigurable", "LOOKUP_WINDOW"]

LOOKUP_WINDOW = 101
_DILATIONS = (1, 2, 4, 8)
#: The last stack's pooled grid of a 27x48 input (27 -> 13 -> 6 -> 3).
_LAST_HW = (3, 6)


class Conv3DConfigurable(nn.Module):
    """A separable (2+1)D conv: (1, 3, 3) to 2F channels, then (3, 1, 1)
    at temporal dilation ``dilation_rate`` to F channels; no bias."""

    def __init__(self, in_filters: int, filters: int, dilation_rate: int):
        super().__init__()
        self.layers = nn.ModuleList([
            nn.Conv3d(in_filters, 2 * filters, (1, 3, 3), padding=(0, 1, 1),
                      bias=False),
            nn.Conv3d(2 * filters, filters, (3, 1, 1),
                      dilation=(dilation_rate, 1, 1),
                      padding=(dilation_rate, 0, 0), bias=False)])

    def forward(self, x):
        return self.layers[1](self.layers[0](x))


class DilatedDCNNV2(nn.Module):
    """Four dilated separable branches, concatenated, BatchNorm, and the
    ReLU unless this is its stack's last cell."""

    def __init__(self, in_filters: int, filters: int, activation: bool):
        super().__init__()
        for d in _DILATIONS:
            setattr(self, f'Conv3D_{d}',
                    Conv3DConfigurable(in_filters, filters, d))
        self.bn = nn.BatchNorm3d(filters * 4, eps=1e-3)
        self.activation = activation

    def forward(self, x):
        x = torch.cat([getattr(self, f'Conv3D_{d}')(x) for d in _DILATIONS],
                      dim=1)
        x = self.bn(x)
        return F.relu(x) if self.activation else x


class StackedDDCNNV2(nn.Module):
    """S cells, ReLU, the first cell's output added, a (1, 2, 2) average
    pool."""

    def __init__(self, in_filters: int, n_blocks: int, filters: int):
        super().__init__()
        self.DDCNN = nn.ModuleList([
            DilatedDCNNV2(in_filters if i == 0 else filters * 4, filters,
                          activation=i != n_blocks - 1)
            for i in range(n_blocks)])

    def forward(self, x):
        shortcut = None
        for block in self.DDCNN:
            x = block(x)
            if shortcut is None:
                shortcut = x
        x = F.relu(x) + shortcut
        # The (1, 2, 2) average pool as a 2-D one over (B, C x T) planes:
        # the same values, and the CPU has no bf16 ``avg_pool3d``.
        b, c, t = x.shape[:3]
        x = F.avg_pool2d(x.flatten(1, 2), 2)
        return x.view(b, c, t, *x.shape[2:])


def _band(sim: torch.Tensor, lookup: int) -> torch.Tensor:
    """(B, T, T) -> (B, T, lookup): row t's entries t - lookup // 2 .. t +
    lookup // 2, zero outside [0, T)."""
    half = (lookup - 1) // 2
    b, t, _ = sim.shape
    padded = F.pad(sim, (half, half)).contiguous()          # (B, T, T + 2h)
    return padded.as_strided((b, t, lookup),
                             (padded.stride(0), padded.stride(1) + 1, 1))


class FrameSimilarity(nn.Module):
    def __init__(self, in_filters: int, similarity_dim: int = 128,
                 lookup_window: int = LOOKUP_WINDOW, output_dim: int = 128):
        super().__init__()
        self.projection = nn.Linear(in_filters, similarity_dim)
        self.fc = nn.Linear(lookup_window, output_dim)
        self.lookup_window = lookup_window

    def forward(self, features: list):
        x = torch.cat([f.mean(dim=(3, 4)) for f in features], dim=1)
        x = F.normalize(self.projection(x.transpose(1, 2)), p=2, dim=2)
        sim = torch.bmm(x, x.transpose(1, 2))
        return F.relu(self.fc(_band(sim, self.lookup_window)))


class ColorHistograms(nn.Module):
    def __init__(self, lookup_window: int = LOOKUP_WINDOW,
                 output_dim: int = 128):
        super().__init__()
        self.fc = nn.Linear(lookup_window, output_dim)
        self.lookup_window = lookup_window

    @staticmethod
    def histograms(frames: torch.Tensor) -> torch.Tensor:
        """(B, T, H, W, 3) uint8 -> (B, T, 512) float32, L2-normalised:
        bin (R >> 5) << 6 | (G >> 5) << 3 | B >> 5, counted in int32."""
        b, t = frames.shape[:2]
        v = frames.reshape(b * t, -1, 3).to(torch.int64) >> 5
        bins = (v[..., 0] << 6) + (v[..., 1] << 3) + v[..., 2]
        bins = bins + (torch.arange(b * t, device=frames.device) << 9)[:, None]
        counts = torch.zeros(b * t * 512, dtype=torch.int32,
                             device=frames.device)
        counts.scatter_add_(0, bins.reshape(-1),
                            torch.ones(bins.numel(), dtype=torch.int32,
                                       device=frames.device))
        return F.normalize(counts.view(b, t, 512).float(), p=2, dim=2)

    def forward(self, frames: torch.Tensor):
        x = self.histograms(frames)
        band = _band(torch.bmm(x, x.transpose(1, 2)), self.lookup_window)
        return F.relu(self.fc(band.to(self.fc.weight.dtype)))


class TransNetV2(nn.Module):
    """(B, T, 27, 48, 3) uint8 frames -> (B, T) float32 transition
    probabilities, ``sigmoid`` of the one-hot head."""

    #: The published cut threshold on ``sigmoid(one_hot)``.
    threshold = 0.5

    def __init__(self, F: int = 16, L: int = 3, S: int = 2, D: int = 1024):
        super().__init__()
        self.F, self.L, self.S, self.D = F, L, S, D
        self.SDDCNN = nn.ModuleList(
            [StackedDDCNNV2(3 if i == 0 else F * 2 ** (i - 1) * 4, S,
                            F * 2 ** i) for i in range(L)])
        self.frame_sim_layer = FrameSimilarity(
            sum(F * 2 ** i * 4 for i in range(L)))
        self.color_hist_layer = ColorHistograms()
        last = F * 2 ** (L - 1) * 4 * _LAST_HW[0] * _LAST_HW[1]
        self.fc1 = nn.Linear(last + 128 + 128, D)
        self.cls_layer1 = nn.Linear(D, 1)
        self.cls_layer2 = nn.Linear(D, 1)
        self.eval()                     # as the published module starts

    @classmethod
    def from_state_dict(cls, state: dict) -> "TransNetV2":
        """A module of the widths a (published-format) state dict holds,
        loaded with it strictly."""
        n_l = 1 + max(int(k.split('.')[1]) for k in state
                      if k.startswith('SDDCNN.'))
        n_s = 1 + max(int(k.split('.')[3]) for k in state
                      if k.startswith('SDDCNN.0.DDCNN.'))
        f = state['SDDCNN.0.DDCNN.0.Conv3D_1.layers.1.weight'].shape[0]
        model = cls(F=f, L=n_l, S=n_s, D=state['fc1.weight'].shape[0])
        model.load_state_dict(state)
        return model

    def logits(self, frames: torch.Tensor):
        """(B, T, 27, 48, 3) uint8 -> (one-hot, many-hot) logits, each
        (B, T) in the parameters' dtype."""
        dtype = self.fc1.weight.dtype
        x = frames.permute(0, 4, 1, 2, 3).to(dtype) / 255.0
        features = []
        with timing.span('transnet.stacks'):
            for stack in self.SDDCNN:
                x = stack(x)
                features.append(x)
        with timing.span('transnet.similarity'):
            sim = self.frame_sim_layer(features)
            hist = self.color_hist_layer(frames)
        b, _, t = x.shape[:3]
        x = x.permute(0, 2, 3, 4, 1).reshape(b, t, -1)     # (h, w, c) order
        x = F.relu(self.fc1(torch.cat([hist, sim, x], dim=2)))
        return self.cls_layer1(x)[..., 0], self.cls_layer2(x)[..., 0]

    def forward(self, frames):
        return torch.sigmoid(self.logits(frames)[0].float())
