"""TransNet V1 shot-boundary detector (PyTorch, NCDHW).

Port of ``retargetvid_tpu/models/transnet.py:DDCNN, TransNetV1``: uint8
frames (B, T, 27, 48, 3) scaled by 1/255, then L=3 stages of S=2 DDCNN
cells -- four parallel 3x3x3 Conv3Ds with temporal dilations 1, 2, 4, 8
(bias, ReLU), concatenated on channels -- each stage ending in a spatial
1x2x2 max-pool; then per-frame flatten, Dense(256) + ReLU, Dense(2) and
``softmax[..., 1]`` in float32.

The JAX package folds time into the batch and runs three 2-D convs per cell
(a TPU lowering workaround); ``nn.Conv3d`` with ``dilation=(d, 1, 1)`` and
``padding=(d, 1, 1)`` is the same function.  The JAX model flattens each
frame's features in (h, w, c) order, so the port permutes to channels-last
before the flatten and ``dense1`` keeps the JAX row order.

Clip-level plans (port of ``TransNetPredictor``, ``IngestShotProgram`` and
``predict_video_windows``): the reference's 100-frame windows with stride
50 over the edge-padded clip, keeping each window's middle [25:75)
(``transnetv1_handler.py:100-130``), run as one batched forward; or one
forward over the whole edge-padded clip (``fullseq``).  Windows are built
by reshaping the clamped-gather of the padded clip into ``stride``-frame
blocks and concatenating ``window // stride`` shifted block views, as the
JAX package does.  Each window's convs zero-pad at the window's own edges,
so the windowed plan is the reference's, and a window spanning the whole
clip computes exactly what ``fullseq`` computes.  Both plans also serve
``models.transnetv2.TransNetV2``, which has the same interface, and count
the frames their forward processed (``transnet_frames``).

The cut threshold belongs to the detector: :func:`cut_threshold` reads a
model's or predictor's ``threshold`` (``TransNetV1.threshold`` is the
reference's 0.1, ``TransNetV2.threshold`` the published 0.5).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from retargetvid_tpu_torch.config import TRANS_THRESHOLD
from retargetvid_tpu_torch.device import resolve_device
from retargetvid_tpu_torch.utils import timing

__all__ = ["TransNetV1", "DDCNN", "INPUT_HEIGHT", "INPUT_WIDTH",
           "cut_threshold", "window_forward", "fullseq_forward",
           "predict_video_windows", "TransNetPredictor", "IngestShotProgram"]

INPUT_HEIGHT = 27
INPUT_WIDTH = 48
_DILATIONS = (1, 2, 4, 8)


def cut_threshold(detector) -> float:
    """The transition probability above which ``detector`` (a model, a
    predictor, or any callable giving probabilities) calls a cut: its
    ``threshold``, else TransNet V1's."""
    return float(getattr(detector, 'threshold', TRANS_THRESHOLD))


class DDCNN(nn.Module):
    """Four temporally dilated 3x3x3 convs (ReLU), channel-concatenated."""

    def __init__(self, in_ch: int, filters: int):
        super().__init__()
        for d in _DILATIONS:
            setattr(self, f'conv3d_dil{d}', nn.Conv3d(
                in_ch, filters, 3, dilation=(d, 1, 1), padding=(d, 1, 1)))

    def forward(self, x):
        return torch.cat([F.relu(getattr(self, f'conv3d_dil{d}')(x))
                          for d in _DILATIONS], dim=1)


class TransNetV1(nn.Module):
    """(B, T, 27, 48, 3) uint8 frames -> (B, T) float32 transition probs.

    The conv/dense stack computes in the dtype of the module's parameters
    (cast the module with ``.to(torch.bfloat16)`` for bf16, as the JAX
    model's ``dtype`` does); the softmax runs in float32.
    """

    #: The reference's cut threshold (``smartVidCrop.py:64``).
    threshold = TRANS_THRESHOLD

    def __init__(self, f: int = 16, l: int = 3, s: int = 2, d: int = 256):
        super().__init__()
        self.f, self.l, self.s, self.d = f, l, s, d
        in_ch = 3
        for idx_l in range(l):
            filters = (2 ** idx_l) * f
            for idx_s in range(s):
                setattr(self, f'sddcnn{idx_l + 1}_ddcnn{idx_s + 1}',
                        DDCNN(in_ch, filters))
                in_ch = 4 * filters
        h, w = INPUT_HEIGHT, INPUT_WIDTH
        for _ in range(l):
            h, w = h // 2, w // 2
        self.dense1 = nn.Linear(h * w * in_ch, d)
        self.dense2 = nn.Linear(d, 2)

    def forward(self, frames):
        dtype = self.dense1.weight.dtype
        x = frames.to(dtype) / 255.0
        x = x.permute(0, 4, 1, 2, 3)                    # (B, C, T, H, W)
        for idx_l in range(self.l):
            for idx_s in range(self.s):
                x = getattr(self, f'sddcnn{idx_l + 1}_ddcnn{idx_s + 1}')(x)
            x = F.max_pool3d(x, (1, 2, 2), stride=(1, 2, 2))
        b, _, t = x.shape[:3]
        x = x.permute(0, 2, 3, 4, 1).reshape(b, t, -1)  # (h, w, c) order
        x = F.relu(self.dense1(x))
        logits = self.dense2(x)
        return torch.softmax(logits.float(), dim=-1)[..., 1]


def window_forward(model: nn.Module, frames: torch.Tensor, n: int, cap: int,
                   *, window: int = 100, stride: int = 50,
                   keep: tuple = (25, 75)) -> torch.Tensor:
    """The window plan over the first ``n`` of ``frames`` (T, 27, 48, 3):
    ``cap`` >= ``n`` probabilities, the first ``n`` of them the clip's.

    The clip is edge-padded by a clamped gather (frame ``-keep[0] + i``
    clamped to [0, n-1]) up to a whole number of ``stride`` blocks that
    holds ``cap`` frames plus the window margins; window i is blocks
    [i, i + window // stride).  So ``cap`` sets the window count (the JAX
    predictor pads N to a multiple of 64, the one-shot body does not), and
    the windows over the first ``n`` frames are the same either way.
    """
    m = window // stride
    kk = -(-(cap + window - stride + keep[0]) // stride)
    n_w = kk - m + 1
    src = torch.clamp(torch.arange(kk * stride, device=frames.device)
                      - keep[0], 0, n - 1)
    blocks = frames[src].reshape(kk, stride, *frames.shape[1:])
    windows = torch.cat([blocks[off:off + n_w] for off in range(m)], dim=1)
    timing.count('transnet_frames', n_w * window)
    probs = model(windows)                                  # (n_w, window)
    return probs[:, keep[0]:keep[1]].reshape(-1)[:cap]


def fullseq_forward(model: nn.Module, frames: torch.Tensor, n: int, cap: int,
                    *, keep: tuple = (25, 75)) -> torch.Tensor:
    """One forward over the first ``n`` of ``frames`` edge-padded by
    ``keep[0]`` frames each side (clamped gather): ``cap`` probabilities."""
    src = torch.clamp(torch.arange(cap + 2 * keep[0], device=frames.device)
                      - keep[0], 0, n - 1)
    timing.count('transnet_frames', cap + 2 * keep[0])
    return model(frames[src][None])[0][keep[0]:keep[0] + cap]


def predict_video_windows(apply_fn, frames, window: int = 100,
                          stride: int = 50, keep: tuple = (25, 75),
                          batch_windows: int = 64) -> np.ndarray:
    """The reference's window plan, eagerly: (N, 27, 48, 3) uint8 ->
    (N,) float32 numpy probabilities.

    Pads 25 edge frames in front and 25..74 behind so the padded clip is a
    whole number of ``stride`` blocks, pads the window count to a multiple
    of 8 (of ``batch_windows`` beyond it) with zero windows, and calls
    ``apply_fn`` (B, T, 27, 48, 3) -> (B, T) once per ``batch_windows``
    windows.  The reference for :class:`TransNetPredictor`.
    """
    if window % stride:
        raise ValueError('window must be a multiple of stride')
    frames = torch.as_tensor(frames)
    n = len(frames)
    rem = n % stride
    pad_end = keep[0] + stride - (rem if rem != 0 else stride)
    padded = torch.cat([frames[:1].repeat_interleave(keep[0], 0), frames,
                        frames[-1:].repeat_interleave(pad_end, 0)])
    m = window // stride
    blocks = padded.reshape(-1, stride, *padded.shape[1:])
    n_w = blocks.shape[0] - m + 1
    n_w_pad = (min(-(-n_w // 8) * 8, batch_windows) if n_w <= batch_windows
               else -(-n_w // batch_windows) * batch_windows)
    if n_w_pad > n_w:
        blocks = torch.cat([blocks, blocks.new_zeros(
            (n_w_pad - n_w,) + tuple(blocks.shape[1:]))])
    windows = torch.cat([blocks[off:off + n_w_pad] for off in range(m)],
                        dim=1)
    probs = torch.cat([apply_fn(windows[i:i + batch_windows])
                       [:, keep[0]:keep[1]]
                       for i in range(0, n_w_pad, batch_windows)])
    return probs[:n_w].reshape(-1)[:n].detach().float().cpu().numpy()


def _pad64(n: int) -> int:
    return -(-n // 64) * 64


class TransNetPredictor:
    """Whole-clip shot probabilities: (N, 27, 48, 3) uint8 -> (N,) numpy.

    The window plan (default) or ``fullseq``: one forward over the
    edge-padded clip, about half the window plan's compute, equal to it
    only where no window edge truncates the ~48-frame receptive field.
    ``N`` is padded up to a multiple of 64 for the window count, as in the
    JAX predictor; the padding is never read.  The model computes in its
    parameters' dtype.  ``device=None`` means the GPU.
    """

    def __init__(self, model: nn.Module, *, window: int = 100,
                 stride: int = 50, keep: tuple = (25, 75),
                 fullseq: bool = False, device=None):
        if window % stride:
            raise ValueError('window must be a multiple of stride')
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.threshold = cut_threshold(model)
        self.window = window
        self.stride = stride
        self.keep = keep
        self.fullseq = fullseq

    def __call__(self, frames) -> np.ndarray:
        frames = torch.as_tensor(frames).to(self.device)
        n = int(frames.shape[0])
        with torch.inference_mode():
            if self.fullseq:
                p = fullseq_forward(self.model, frames, n, _pad64(n),
                                    keep=self.keep)
            else:
                p = window_forward(self.model, frames, n, _pad64(n),
                                   window=self.window, stride=self.stride,
                                   keep=self.keep)
        return p[:n].float().cpu().numpy()


class IngestShotProgram:
    """Raw frames -> (saliency-resolution frames, shot probabilities).

    The ingest's two resizes (``pipeline.ingest._resize_kernel``) and the
    TransNet window plan of :class:`TransNetPredictor`.  The saliency
    frames stay on the device for ``pipeline.fused.FusedClipProgram``; only
    the (N,) probabilities go to the host, where the sampling rule needs
    them.  ``device=None`` means the GPU.
    """

    def __init__(self, model: nn.Module, *, sal_hw, window: int = 100,
                 stride: int = 50, keep: tuple = (25, 75), device=None):
        self.predictor = TransNetPredictor(model, window=window,
                                           stride=stride, keep=keep,
                                           device=device)
        self.device = self.predictor.device
        self.threshold = self.predictor.threshold
        self.sal_hw = tuple(sal_hw)

    def __call__(self, frames):
        """(N, H, W, 3) uint8 -> (device (N, sal_h, sal_w, 3) uint8,
        numpy (N,) float32)."""
        from retargetvid_tpu_torch.pipeline.ingest import _resize_kernel

        frames = torch.as_tensor(frames).to(self.device)
        resize = _resize_kernel(int(frames.shape[1]), int(frames.shape[2]),
                                *self.sal_hw)
        with torch.inference_mode():
            tn, sal = resize(frames)
        return sal, self.predictor(tn)
