"""TransNet V1 (Soucek et al., 2019), plain PyTorch, NCDHW.

uint8 frames (B, T, 27, 48, 3) scaled by 1/255, L=3 stages of S=2 DDCNN
cells (four parallel 3x3x3 Conv3Ds with temporal dilations 1, 2, 4, 8, bias
and ReLU, concatenated on channels), each stage ending in a 1x2x2 max-pool;
per-frame flatten in (h, w, c) order, Dense(D) + ReLU, Dense(2) and
``softmax[..., 1]`` in float32.  Parameter names are the repository port's.
:func:`fullseq_forward` is the full-sequence plan: one forward over the clip
edge-padded by 25 frames on each side.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

INPUT_HEIGHT = 27
INPUT_WIDTH = 48
_DILATIONS = (1, 2, 4, 8)


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


def fullseq_forward(model: nn.Module, frames: torch.Tensor, n: int, cap: int,
                    *, keep: tuple = (25, 75)) -> torch.Tensor:
    """One forward over the first ``n`` of ``frames`` edge-padded by
    ``keep[0]`` frames each side (clamped gather): ``cap`` probabilities."""
    src = torch.clamp(torch.arange(cap + 2 * keep[0], device=frames.device)
                      - keep[0], 0, n - 1)
    return model(frames[src][None])[0][keep[0]:keep[0] + cap]
