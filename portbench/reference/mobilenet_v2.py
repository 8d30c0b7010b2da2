"""MobileNetV2 backbone of the reference UNISAL (plain PyTorch, NCHW).

The standard inverted-residual table; the first block of every group is
built with ``omit_stride=True`` and subsampled afterwards by ``::2``;
``feat_4x`` is block 7's output and ``feat_2x`` block 14's, both before
their subsample; a trailing 1x1 conv to ``last_channel``.
"""

from __future__ import annotations

from typing import Optional

from torch import nn

from portbench.reference.layers import ConvBN, Conv1x1BN, InvertedResidual

# (expand_ratio, channels, repeats, stride)
INVERTED_RESIDUAL_SETTING = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)


class MobileNetV2(nn.Module):
    """Returns (feat_1x, feat_2x, feat_4x)."""

    def __init__(self, widen_factor: float = 1.0, input_channel: int = 32,
                 last_channel: Optional[int] = 1280):
        super().__init__()
        self.widen_factor = widen_factor
        self.last_channel = last_channel
        inp = int(input_channel * widen_factor)
        self.features_0 = ConvBN(3, inp, stride=2)
        self._strides = []
        idx, in_ch = 1, inp
        for t, c, n, s in INVERTED_RESIDUAL_SETTING:
            out_ch = int(c * widen_factor)
            for i in range(n):
                block_stride = s if i == 0 else 1
                setattr(self, f'features_{idx}', InvertedResidual(
                    in_ch, out_ch, stride=block_stride, expand_ratio=t,
                    omit_stride=(i == 0)))
                self._strides.append(block_stride)
                in_ch = out_ch
                idx += 1
        self.n_blocks = idx - 1
        if last_channel is not None:
            setattr(self, f'features_{idx}',
                    Conv1x1BN(in_ch, self.out_channels))

    @property
    def out_channels(self) -> int:
        if self.last_channel is not None:
            return (int(self.last_channel * self.widen_factor)
                    if self.widen_factor > 1.0 else self.last_channel)
        return int(INVERTED_RESIDUAL_SETTING[-1][1] * self.widen_factor)

    @property
    def feat_2x_channels(self) -> int:
        return int(INVERTED_RESIDUAL_SETTING[-2][1] * self.widen_factor)

    @property
    def feat_4x_channels(self) -> int:
        return int(INVERTED_RESIDUAL_SETTING[-4][1] * self.widen_factor)

    def forward(self, x):
        x = self.features_0(x)
        feat_2x = feat_4x = None
        for idx in range(1, self.n_blocks + 1):
            x = getattr(self, f'features_{idx}')(x)
            if idx == 7:
                feat_4x = x
            elif idx == 14:
                feat_2x = x
            if self._strides[idx - 1] != 1:
                x = x[..., ::2, ::2]
        if self.last_channel is not None:
            x = getattr(self, f'features_{self.n_blocks + 1}')(x)
        return x, feat_2x, feat_4x
