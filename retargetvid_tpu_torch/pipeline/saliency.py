"""Saliency inference: network grid, preprocessing and the predictor.

Port of ``retargetvid_tpu/pipeline/saliency.py`` (reference
``unisal/data.py:1086-1103, 1241-1313``, ``unisal/train.py:425-556,
1255-1279``): PIL-LANCZOS resize to a x32 grid (with PIL's uint8
rounding), /255, ImageNet normalisation, the UNISAL forward (static per
frame in ``predict``, the ConvGRU over interleaved frame-modulo sequences
in ``predict_video``) and the per-frame exp + max-normalize to uint8, which
on the card is the hand-written saliency-postprocess kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from retargetvid_tpu_torch.device import resolve_device
from retargetvid_tpu_torch.kernels.postprocess import saliency_postprocess
from retargetvid_tpu_torch.ops.resize import resize, round_half_up
from retargetvid_tpu_torch.utils import timing
from retargetvid_tpu_torch.utils.sequence import smooth_sequence

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
    timing.count('dispatch_syncs', 2)      # mean and std, from the host
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
    postprocess kernel launch per chunk on the card.  ``predict_video`` is
    the dynamic (ConvGRU) mode.  ``device=None`` means the GPU.  A
    ``timer`` (``utils.timing.StageTimer``) is active during each
    ``predict_video`` call.
    """

    def __init__(self, model, source: str = 'SALICON', chunk: int = 32,
                 dtype=torch.float32, device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.source = source
        self.chunk = chunk
        self.dtype = dtype
        self.timer = None

    def predict_video(self, frames, *, source: str = 'DHF1K',
                      frame_modulo: int = 4, seq_len: int = 6,
                      smooth_method: Optional[str] = None):
        """Dynamic (ConvGRU) whole-video saliency with the reference's
        interleaved frame-modulo scheme: each of the ``frame_modulo``
        phase-offset subsequences runs through the recurrent model in
        ``seq_len``-frame chunks (a ragged tail padded with its last frame,
        then trimmed), the hidden state carried across chunks.
        ``smooth_method`` (``'med<k>'``) median-smooths the interleaved
        log-probabilities on the device; one postprocess launch then covers
        the whole (T, H, W) stack.

        (T, H, W, 3) uint8 frames (numpy or a tensor) -> (T, H, W) uint8
        numpy maps.  Stage: ``chunks``.
        """
        frames = torch.as_tensor(frames).to(self.device)
        t, h, w, _ = frames.shape
        net_hw = get_optimal_out_size((h, w))
        with timing.active(self.timer, self.device), \
                torch.inference_mode():
            logps = torch.empty((t, h, w), dtype=torch.float32,
                                device=self.device)
            with timing.span('chunks'):
                for offset in range(min(frame_modulo, t)):
                    seq = frames[offset::frame_modulo]
                    out = logps[offset::frame_modulo]
                    h0 = None
                    for s in range(0, len(seq), seq_len):
                        batch = seq[s:s + seq_len]
                        n = len(batch)
                        if n < seq_len:          # ragged tail: pad, trim
                            batch = torch.cat([batch, batch[-1:].expand(
                                seq_len - n, -1, -1, -1)])
                        x = preprocess_frames(batch, net_hw).to(self.dtype)
                        logp, h0 = self.model.forward_with_hidden(
                            x[None], target_size=(h, w), source=source,
                            static=False, h0=h0)
                        out[s:s + n] = logp[0, :n, :, :, 0]
            if smooth_method is not None:
                logps = smooth_sequence(logps, smooth_method)
            maps = saliency_postprocess(logps)
        return maps.cpu().numpy()

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
