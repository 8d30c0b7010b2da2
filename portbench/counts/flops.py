"""Conv and dense FLOPs of a forward, counted from the layers' shapes.

A frozen copy of the counting in the repository port's ``mfu.py``: for
every conv and dense call, 2 x output elements x the product of the
weight's shape past its first axis ((in channels / groups) x kernel volume
for a conv, in features for a dense layer).  The forward runs on the
``meta`` device, which computes shapes only.  Elementwise work
(BatchNorm, activations, resizes, softmax, the postprocess) is not counted.
``FlopCounterMode`` counts the same forward as a cross-check (the tests).

The models counted are the reference's (``portbench/reference``), which
have the program's architecture, at the live sizes a clip gives them.
"""

from __future__ import annotations

import copy
import math
from typing import Callable

import torch
from torch.nn import functional as F
from torch.overrides import TorchFunctionMode
from torch.utils.flop_counter import FlopCounterMode

#: NVIDIA H100 SXM dense peaks (data sheet, 700 W), FLOP/s.
PEAK_FLOPS = {'bfloat16': 989e12, 'tf32': 495e12, 'float32': 67e12}

_LAYERS = {F.conv1d, F.conv2d, F.conv3d, torch.conv1d, torch.conv2d,
           torch.conv3d, F.linear}


class LayerFlops(TorchFunctionMode):
    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func in _LAYERS:
            weight = args[1] if len(args) > 1 else kwargs['weight']
            self.total += 2 * out.numel() * math.prod(weight.shape[1:])
        return out


def _on_meta(fn: Callable, model, *shapes_dtypes):
    meta = copy.deepcopy(model).to('meta')
    args = [torch.empty(s, dtype=d, device='meta') for s, d in shapes_dtypes]
    with torch.inference_mode():
        fn(meta, *args)


def layer_flops(fn: Callable, model, *shapes_dtypes) -> int:
    """The count of ``fn(model, *inputs)``, inputs of the given (shape,
    dtype) pairs."""
    mode = LayerFlops()
    with mode:
        _on_meta(fn, model, *shapes_dtypes)
    return mode.total


def counter_flops(fn: Callable, model, *shapes_dtypes) -> int:
    """``FlopCounterMode``'s total for the same call."""
    counter = FlopCounterMode(display=False)
    with counter:
        _on_meta(fn, model, *shapes_dtypes)
    return counter.get_total_flops()


def _transnet(model, x):
    return model(x)


def _unisal_static(model, x, target):
    return model(x, target_size=target, source='SALICON')


def transnet_fullseq(model, frames: int, keep: int = 25) -> int:
    """TransNet over a clip's full-sequence context: ``frames`` plus
    ``keep`` edge frames on each side, 27x48."""
    return layer_flops(_transnet, model,
                       ((1, frames + 2 * keep, 27, 48, 3), torch.uint8))


def unisal_static(model, picks: int, net_hw, out_hw) -> int:
    """UNISAL's static forward over ``picks`` frames of ``net_hw``."""
    return layer_flops(lambda m, x: _unisal_static(m, x, tuple(out_hw)),
                       model, ((picks, 1, *net_hw, 3), torch.float32))


def unisal_dynamic(model, frames: int, net_hw, out_hw, seq_len: int,
                   frame_modulo: int) -> int:
    """UNISAL with its ConvGRU over a clip in the frame-modulo scheme:
    every chunk of ``seq_len`` frames (a ragged tail padded), counted once
    per chunk shape."""
    chunks = 0
    for offset in range(min(frame_modulo, frames)):
        n = len(range(offset, frames, frame_modulo))
        chunks += -(-n // seq_len)
    per_chunk = layer_flops(
        lambda m, x: m(x, target_size=tuple(out_hw), source='DHF1K',
                       static=False),
        model, ((1, seq_len, *net_hw, 3), torch.float32))
    return chunks * per_chunk
