"""TransNet V2's FLOPs in the 100/50 window plan, counted on the ``meta``
device from the reference (``portbench/reference/transnetv2.py``).

The plan is the program's (``models/transnet.py:window_forward``, as the
one-shot body calls it with the clip's frame count as capacity): the clip
edge-padded to whole 50-frame blocks that hold it and the windows'
margins, one batch of ``n_w`` 100-frame windows.  For 480 frames that is
12 blocks and 11 windows, 1,100 frames.

Counted: 2 x output elements x the weight's shape past its first axis for
every conv and dense call (as ``flops.py``), and 2 x b x m x n x k for
every ``bmm`` (the two T x T similarity products); ``FlopCounterMode``
counts the same (the tests).  Elementwise work, BatchNorm, pooling, the
histogram's ``scatter_add_`` and the band gathers are not counted.
"""

from __future__ import annotations

import torch

from portbench.counts import flops

WINDOW, STRIDE, KEEP = 100, 50, 25
HIST_BINS = 512


class _WithBmm(flops.LayerFlops):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = super().__torch_function__(func, types, args, kwargs)
        if func is torch.bmm:
            self.total += 2 * out.numel() * args[0].shape[-1]
        return out


def windows(frames: int) -> int:
    """The window plan's window count for a clip of ``frames``."""
    blocks = -(-(frames + WINDOW - STRIDE + KEEP) // STRIDE)
    return blocks - WINDOW // STRIDE + 1


def _batch(frames: int):
    return ((windows(frames), WINDOW, 27, 48, 3), torch.uint8)


def _forward(model, x):
    return model(x)


def _stacks(model, x):
    x = x.permute(0, 4, 1, 2, 3).to(model.fc1.weight.dtype) / 255.0
    for stack in model.SDDCNN:
        x = stack(x)
    return x


def window_plan(model, frames: int) -> int:
    """Conv, dense and ``bmm`` FLOPs of the window plan over a clip."""
    mode = _WithBmm()
    with mode:
        flops._on_meta(_forward, model, _batch(frames))
    return mode.total


def window_plan_counter(model, frames: int) -> int:
    """``FlopCounterMode``'s total for the same forward."""
    return flops.counter_flops(_forward, model, _batch(frames))


def histogram_bmm(frames: int) -> int:
    """The colour histograms' T x T ``bmm`` (float32 in the program)."""
    return windows(frames) * 2 * WINDOW * WINDOW * HIST_BINS


def stacks(model, frames: int) -> int:
    """The three stacks' conv FLOPs in the window plan."""
    return flops.layer_flops(_stacks, model, _batch(frames))
