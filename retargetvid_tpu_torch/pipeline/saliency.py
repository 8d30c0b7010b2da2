"""Saliency inference: network grid, preprocessing and the predictor.

Port of ``retargetvid_tpu/pipeline/saliency.py:get_optimal_out_size,
preprocess_frames, SaliencyPredictor.predict`` (reference
``unisal/data.py:1086-1103, 1241-1313``, ``unisal/train.py:1255-1279``):
PIL-LANCZOS resize to a x32 grid (with PIL's uint8 rounding), /255,
ImageNet normalisation, the UNISAL static forward and the per-frame
exp + max-normalize to uint8, which on the card is the hand-written
saliency-postprocess kernel.  The dynamic (ConvGRU) ``predict_video`` is
not ported.
"""

from __future__ import annotations

from typing import Tuple

import torch

from retargetvid_tpu_torch.device import resolve_device
from retargetvid_tpu_torch.kernels.postprocess import saliency_postprocess
from retargetvid_tpu_torch.ops.resize import resize, round_half_up

__all__ = ["get_optimal_out_size", "preprocess_frames", "SaliencyPredictor",
           "IMAGENET_MEAN", "IMAGENET_STD"]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def get_optimal_out_size(img_size: Tuple[int, int]) -> Tuple[int, int]:
    """The x32 network grid best matching the aspect ratio: (n1, n2) in
    [7, 13]^2 with 100 <= n1*n2 <= 120, times 32."""
    ar = img_size[0] / img_size[1]
    best, best_ratio = None, -1.0
    for n1 in range(7, 14):
        for n2 in range(7, 14):
            if 100 <= n1 * n2 <= 120:
                this_ar = n1 / n2
                ratio = min(ar, this_ar) / max(ar, this_ar)
                if ratio > best_ratio:
                    best_ratio = ratio
                    best = (n1, n2)
    return (best[0] * 32, best[1] * 32)


def preprocess_frames(frames: torch.Tensor,
                      out_size: Tuple[int, int]) -> torch.Tensor:
    """uint8 (B, H, W, 3) -> normalised float32 (B, h, w, 3)."""
    x = resize(frames, out_size, 'lanczos', channels_last=True)
    x = torch.clamp(round_half_up(x), 0, 255) / 255.0
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32,
                        device=frames.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32,
                       device=frames.device)
    return (x - mean) / std


class SaliencyPredictor:
    """Batched static-mode UNISAL inference producing uint8 saliency maps.

    ``predict(frames)``: uint8 (T, H, W, 3) RGB -> uint8 (T, H, W) maps.
    ``model`` is a port ``UNISAL``; its input is cast to ``dtype`` and it
    computes in its parameters' dtype.  Frames go through in chunks of
    ``chunk`` (a ragged tail is padded with its last frame and trimmed), one
    postprocess kernel launch per chunk on the card.  ``device=None`` means
    the GPU.
    """

    def __init__(self, model, source: str = 'SALICON', chunk: int = 32,
                 dtype=torch.float32, device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.source = source
        self.chunk = chunk
        self.dtype = dtype

    def predict(self, frames, return_device: bool = False):
        """(T, H, W, 3) uint8 frames (numpy or a tensor) -> (T, H, W) uint8
        maps: numpy, or with ``return_device=True`` a tensor left on the
        predictor's device."""
        frames = torch.as_tensor(frames).to(self.device)
        t, h, w, _ = frames.shape
        net_hw = get_optimal_out_size((h, w))
        chunks = []
        with torch.inference_mode():
            for s in range(0, t, self.chunk):
                e = min(t, s + self.chunk)
                batch = frames[s:e]
                if e - s < self.chunk:                  # pad ragged tail
                    batch = torch.cat([batch, batch[-1:].expand(
                        self.chunk - (e - s), -1, -1, -1)])
                x = preprocess_frames(batch, net_hw).to(self.dtype)
                logp = self.model(x[:, None], target_size=(h, w),
                                  source=self.source)
                maps = saliency_postprocess(
                    logp[:, 0, :, :, 0].to(torch.float32).contiguous())
                chunks.append(maps[:e - s])
        out = chunks[0] if len(chunks) == 1 else torch.cat(chunks)
        return out if return_device else out.cpu().numpy()
