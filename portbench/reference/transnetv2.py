"""TransNet V2 (Souček and Lokoč, arXiv:2008.04838), plain PyTorch, NCDHW.

A copy of the authors' PyTorch module (github.com/soCzech/TransNetV2,
``inference-pytorch/transnetv2_pytorch.py``) cut to inference, with its
module and parameter names, so the published state dict and the
program's load here as they are.  :func:`predict_frames` is the authors'
inference plan (``inference/transnetv2.py:predict_frames``): 100-frame
windows at stride 50 over the clip edge-padded by 25 frames in front and
25 to 74 behind, one window per forward, each window's frames [25:75)
kept.

Departures from the published file, none of which changes a float32
result:

- the input is cast to the parameters' dtype (the published file calls
  ``.float()``), and the histogram branch's float32 band to its ``fc``'s
  dtype, so the module runs when cast to bf16 (the denominator of
  ``shot_logit_gap_ratio`` and the control);
- the (1, 2, 2) ``AvgPool3d`` is computed as a 2-D average pool over (B,
  C x T) planes, the same values: PyTorch's CPU has no bf16 3-D average
  pool;
- no dropout (an identity at inference), no training-only options;
- :func:`predict_frames` returns the one-hot head's logits and
  probabilities in float32 rather than numpy probabilities of both heads.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

LOOKUP_WINDOW = 101


class Conv3DConfigurable(nn.Module):
    def __init__(self, in_filters, filters, dilation_rate):
        super().__init__()
        # (2+1)D convolution, separable, without bias (BatchNorm follows).
        conv1 = nn.Conv3d(in_filters, 2 * filters, kernel_size=(1, 3, 3),
                          dilation=(1, 1, 1), padding=(0, 1, 1), bias=False)
        conv2 = nn.Conv3d(2 * filters, filters, kernel_size=(3, 1, 1),
                          dilation=(dilation_rate, 1, 1),
                          padding=(dilation_rate, 0, 0), bias=False)
        self.layers = nn.ModuleList([conv1, conv2])

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


class DilatedDCNNV2(nn.Module):
    def __init__(self, in_filters, filters, activation=None):
        super().__init__()
        self.Conv3D_1 = Conv3DConfigurable(in_filters, filters, 1)
        self.Conv3D_2 = Conv3DConfigurable(in_filters, filters, 2)
        self.Conv3D_4 = Conv3DConfigurable(in_filters, filters, 4)
        self.Conv3D_8 = Conv3DConfigurable(in_filters, filters, 8)
        self.bn = nn.BatchNorm3d(filters * 4, eps=1e-3)
        self.activation = activation

    def forward(self, inputs):
        conv1 = self.Conv3D_1(inputs)
        conv2 = self.Conv3D_2(inputs)
        conv3 = self.Conv3D_4(inputs)
        conv4 = self.Conv3D_8(inputs)
        x = torch.cat([conv1, conv2, conv3, conv4], dim=1)
        x = self.bn(x)
        if self.activation is not None:
            x = self.activation(x)
        return x


class StackedDDCNNV2(nn.Module):
    def __init__(self, in_filters, n_blocks, filters):
        super().__init__()
        self.DDCNN = nn.ModuleList([
            DilatedDCNNV2(in_filters if i == 1 else filters * 4, filters,
                          activation=F.relu if i != n_blocks else None)
            for i in range(1, n_blocks + 1)])

    def forward(self, inputs):
        x = inputs
        shortcut = None
        for block in self.DDCNN:
            x = block(x)
            if shortcut is None:
                shortcut = x
        x = F.relu(x)
        x += shortcut
        # AvgPool3d((1, 2, 2)) as a 2-D pool over (B, C x T) planes.
        b, c, t = x.shape[:3]
        x = F.avg_pool2d(x.flatten(1, 2), 2)
        return x.view(b, c, t, *x.shape[2:])


def _lookup(similarities, lookup_window):
    """The published banded gather: row t's entries t - 50 .. t + 50 of
    the zero-padded (B, T, T) similarities."""
    batch_size, time_window = similarities.shape[0], similarities.shape[1]
    half = (lookup_window - 1) // 2
    padded = F.pad(similarities, [half, half])
    dev = similarities.device
    batch_indices = torch.arange(0, batch_size, device=dev).view(
        [batch_size, 1, 1]).repeat([1, time_window, lookup_window])
    time_indices = torch.arange(0, time_window, device=dev).view(
        [1, time_window, 1]).repeat([batch_size, 1, lookup_window])
    lookup_indices = torch.arange(0, lookup_window, device=dev).view(
        [1, 1, lookup_window]).repeat([batch_size, time_window, 1]) \
        + time_indices
    return padded[batch_indices, time_indices, lookup_indices]


class FrameSimilarity(nn.Module):
    def __init__(self, in_filters, similarity_dim=128,
                 lookup_window=LOOKUP_WINDOW, output_dim=128):
        super().__init__()
        self.projection = nn.Linear(in_filters, similarity_dim, bias=True)
        self.fc = nn.Linear(lookup_window, output_dim)
        self.lookup_window = lookup_window

    def forward(self, inputs):
        x = torch.cat([torch.mean(x, dim=[3, 4]) for x in inputs], dim=1)
        x = torch.transpose(x, 1, 2)
        x = self.projection(x)
        x = F.normalize(x, p=2, dim=2)
        similarities = torch.bmm(x, x.transpose(1, 2))
        return F.relu(self.fc(_lookup(similarities, self.lookup_window)))


class ColorHistograms(nn.Module):
    def __init__(self, lookup_window=LOOKUP_WINDOW, output_dim=128):
        super().__init__()
        self.fc = nn.Linear(lookup_window, output_dim)
        self.lookup_window = lookup_window

    @staticmethod
    def compute_color_histograms(frames):
        frames = frames.int()

        def get_bin(frames):
            # 0 .. 511
            R, G, B = frames[:, :, 0], frames[:, :, 1], frames[:, :, 2]
            R, G, B = R >> 5, G >> 5, B >> 5
            return (R << 6) + (G << 3) + B

        batch_size, time_window, height, width, no_channels = frames.shape
        frames_flatten = frames.view(batch_size * time_window,
                                     height * width, 3)
        binned_values = get_bin(frames_flatten)
        frame_bin_prefix = (torch.arange(0, batch_size * time_window,
                                         device=frames.device) << 9).view(
            -1, 1)
        binned_values = (binned_values + frame_bin_prefix).view(-1)
        histograms = torch.zeros(batch_size * time_window * 512,
                                 dtype=torch.int32, device=frames.device)
        histograms.scatter_add_(0, binned_values, torch.ones(
            len(binned_values), dtype=torch.int32, device=frames.device))
        histograms = histograms.view(batch_size, time_window, 512).float()
        return F.normalize(histograms, p=2, dim=2)

    def forward(self, inputs):
        x = self.compute_color_histograms(inputs)
        similarities = torch.bmm(x, x.transpose(1, 2))
        band = _lookup(similarities, self.lookup_window)
        return F.relu(self.fc(band.to(self.fc.weight.dtype)))


class TransNetV2(nn.Module):
    def __init__(self, F=16, L=3, S=2, D=1024):
        super().__init__()
        self.SDDCNN = nn.ModuleList(
            [StackedDDCNNV2(in_filters=3, n_blocks=S, filters=F)]
            + [StackedDDCNNV2(in_filters=(F * 2 ** (i - 1)) * 4, n_blocks=S,
                              filters=F * 2 ** i) for i in range(1, L)])
        self.frame_sim_layer = FrameSimilarity(
            sum([(F * 2 ** i) * 4 for i in range(L)]), lookup_window=101,
            output_dim=128, similarity_dim=128)
        self.color_hist_layer = ColorHistograms(lookup_window=101,
                                                output_dim=128)
        output_dim = ((F * 2 ** (L - 1)) * 4) * 3 * 6 + 128 + 128
        self.fc1 = nn.Linear(output_dim, D)
        self.cls_layer1 = nn.Linear(D, 1)
        self.cls_layer2 = nn.Linear(D, 1)
        self.eval()

    def forward(self, inputs):
        """uint8 (B, T, 27, 48, 3) -> (one-hot (B, T, 1), {'many_hot': (B,
        T, 1)}) logits in the parameters' dtype."""
        dtype = self.fc1.weight.dtype
        x = inputs.permute([0, 4, 1, 2, 3]).to(dtype)
        x = x.div_(255.)
        block_features = []
        for block in self.SDDCNN:
            x = block(x)
            block_features.append(x)
        x = x.permute(0, 2, 3, 4, 1)
        x = x.reshape(x.shape[0], x.shape[1], -1)
        x = torch.cat([self.frame_sim_layer(block_features), x], 2)
        x = torch.cat([self.color_hist_layer(inputs), x], 2)
        x = F.relu(self.fc1(x))
        one_hot = self.cls_layer1(x)
        return one_hot, {'many_hot': self.cls_layer2(x)}


@torch.no_grad()
def predict_frames(model, frames):
    """(N, 27, 48, 3) uint8 -> (one-hot logits (N,), probabilities (N,)),
    float32: the published window plan, one window per forward."""
    n = len(frames)
    pad_end = 25 + 50 - (n % 50 if n % 50 != 0 else 50)
    padded = torch.cat([frames[:1]] * 25 + [frames] + [frames[-1:]] * pad_end)
    logits = []
    ptr = 0
    while ptr + 100 <= len(padded):
        one_hot, _ = model(padded[ptr:ptr + 100][None])
        logits.append(one_hot[0, 25:75, 0].float())
        ptr += 50
    logits = torch.cat(logits)[:n]
    return logits, torch.sigmoid(logits)
