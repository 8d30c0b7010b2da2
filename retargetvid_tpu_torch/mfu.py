"""FLOPs and MFU of the port's two models on the card.

Counterpart of ``tools/mfu.py``.  The targets are the two conv-heavy
programs of the benchmark clip at the shapes it runs them:

- UNISAL: 96 picks of 140x250 (the bench clip's padded pick count), the
  Lanczos preprocess to 256x416, the static forward to 140x250 at
  SALICON (a bf16 input to float32 parameters, as the one-shot path runs
  it: the convolutions run in TF32 while ``torch.backends.cudnn.allow_tf32``
  is on, its default; JAX's tool casts the input to bf16 and computes in
  bf16) and the postprocess kernel;
- TransNet: the windowed predictor over 580 frames of 27x48 (the streaming
  ingest's shot buffer: a 25-frame overlap, 480 frames and the 75-frame
  zero tail), padded to a multiple of 64, in bf16.

FLOPs are counted, not measured: for each conv and dense layer the forward
calls, 2 x output elements x (input channels / groups) x kernel volume
(in features for a dense layer), from the layer's weight shape and the
output shape it gives at the target's input shape (the forward runs on the
``meta`` device, which computes shapes only).  ``FlopCounterMode`` counts
the same forward as a cross-check.  Elementwise work (BatchNorm,
activations, resizes, softmax, the postprocess) is not counted.

Time is a slope: K = 1 and K = 8 forwards over distinct inputs, each
between two CUDA events, the median of ``--reps`` runs each; the time per
forward is (t8 - t1) / 7, which cancels what a run costs once.  MFU
divides the FLOP rate by the card's published dense peak in the dtype the
convolutions run in (NVIDIA H100 SXM at 700 W: bf16 989 TFLOP/s, TF32 495,
float32 67); the card's name and power limit are printed beside it.

Also printed: the model FLOPs of one bench clip, UNISAL over the 96 padded
picks plus TransNet over the plan ``bench`` ran (530 frames full-sequence,
1100 windowed), and the time those would take at the peaks.

    python -m retargetvid_tpu_torch.mfu [--reps 5]

Without a GPU it raises.  The weights are seeded; nothing is downloaded.
"""

from __future__ import annotations

import argparse
import copy
import json
import math
from typing import Callable

import numpy as np
import torch
from torch.nn import functional as F
from torch.overrides import TorchFunctionMode
from torch.utils.flop_counter import FlopCounterMode

__all__ = ["PEAK_FLOPS", "layer_flops", "counter_flops", "conv_dtype",
           "unisal_target", "transnet_target", "clip_flops", "slope_ms",
           "measure", "main"]

#: NVIDIA H100 SXM dense peaks (data sheet, 700 W), FLOP/s.
PEAK_FLOPS = {'bfloat16': 989e12, 'tf32': 495e12, 'float32': 67e12}

#: The bench clip and what its paths give the models.
CLIP_FRAMES = 480
SAL_HW, NET_HW, PICKS = (140, 250), (256, 416), 96
TN_FRAMES, TN_HW = 580, (27, 48)

#: The conv and dense calls the count covers.
_LAYERS = {F.conv1d, F.conv2d, F.conv3d, torch.conv1d, torch.conv2d,
           torch.conv3d, F.linear}


class _LayerFlops(TorchFunctionMode):
    """Adds up 2 x output elements x the product of the weight's shape
    past its first axis ((in channels / groups) x kernel volume for a
    conv, in features for a dense layer) over every conv and dense call."""

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
    """The analytic count of ``fn(model, *inputs)``, inputs of the given
    (shape, dtype) pairs, from its conv and dense layers' shapes."""
    mode = _LayerFlops()
    with mode:
        _on_meta(fn, model, *shapes_dtypes)
    return mode.total


def counter_flops(fn: Callable, model, *shapes_dtypes) -> int:
    """``FlopCounterMode``'s total for the same call."""
    counter = FlopCounterMode(display=False)
    with counter:
        _on_meta(fn, model, *shapes_dtypes)
    return counter.get_total_flops()


def conv_dtype(param_dtype: torch.dtype) -> str:
    """The dtype the convolutions run in: a float32 model runs in TF32
    while cuDNN's TF32 is allowed."""
    if param_dtype == torch.float32:
        return 'tf32' if torch.backends.cudnn.allow_tf32 else 'float32'
    return {torch.bfloat16: 'bfloat16'}[param_dtype]


def unisal_forward(model, frames):
    """Picks (T, 140, 250, 3) uint8 -> (T, 1, 140, 250, 1) log-
    probabilities: the preprocess and the static forward."""
    from retargetvid_tpu_torch.pipeline.saliency import preprocess_frames
    x = preprocess_frames(frames, NET_HW).to(torch.bfloat16)
    return model(x[:, None], target_size=SAL_HW, source='SALICON')


def unisal_step(model, frames):
    """:func:`unisal_forward` and the postprocess kernel: uint8 maps."""
    from retargetvid_tpu_torch.kernels.postprocess import saliency_postprocess
    logp = unisal_forward(model, frames)
    return saliency_postprocess(logp[:, 0, :, :, 0].float().contiguous())


def transnet_windows(model, frames):
    """The windowed predictor's forward over (N, 27, 48, 3) uint8 frames,
    N padded to a multiple of 64 (``TransNetPredictor``)."""
    from retargetvid_tpu_torch.models.transnet import window_forward
    n = int(frames.shape[0])
    return window_forward(model, frames, n, -(-n // 64) * 64)


def unisal_target(model) -> dict:
    return {'name': f'UNISAL static forward ({PICKS}x{SAL_HW[0]}x'
                    f'{SAL_HW[1]}, bf16 input to float32 parameters)',
            'model': model, 'fn': unisal_step, 'count_fn': unisal_forward,
            'input': ((PICKS, *SAL_HW, 3), torch.uint8),
            'conv_dtype': conv_dtype(next(model.parameters()).dtype)}


def transnet_target(model) -> dict:
    model = model.to(torch.bfloat16)
    return {'name': f'TransNet windows ({TN_FRAMES}x{TN_HW[0]}x{TN_HW[1]}, '
                    'bf16)',
            'model': model, 'fn': transnet_windows,
            'count_fn': transnet_windows,
            'input': ((TN_FRAMES, *TN_HW, 3), torch.uint8),
            'conv_dtype': 'bfloat16'}


def clip_flops(un_model, tn_model) -> dict:
    """Model FLOPs of one bench clip (480 frames of 640x360 at 1:3, 96
    padded picks): UNISAL over the picks, TransNet over each plan's frames
    (the one-shot program's: full-sequence 480 + 2 x 25 edge frames,
    windowed 11 windows of 100), and the ms they would take at the
    peaks."""
    from retargetvid_tpu_torch.models.transnet import (
        fullseq_forward,
        window_forward,
    )

    def tn_plan(forward):
        return layer_flops(
            lambda model, tn: forward(model, tn, CLIP_FRAMES, CLIP_FRAMES),
            tn_model, ((CLIP_FRAMES, *TN_HW, 3), torch.uint8))

    un = layer_flops(unisal_forward, un_model, ((PICKS, *SAL_HW, 3),
                                                torch.uint8))
    un_peak = PEAK_FLOPS[conv_dtype(next(un_model.parameters()).dtype)]
    out = {'unisal_flops': un}
    for plan, forward in (('fullseq', fullseq_forward),
                          ('windowed', window_forward)):
        tn = tn_plan(forward)
        out[f'transnet_{plan}_flops'] = tn
        out[f'clip_{plan}_flops'] = un + tn
        out[f'clip_{plan}_ms_at_peak'] = (
            un / un_peak + tn / PEAK_FLOPS['bfloat16']) * 1e3
    return out


def _runs_ms(fn, model, stacks) -> float:
    """Median CUDA-event ms of ``fn`` over each stack's inputs in turn."""
    times = []
    for stack in stacks:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for x in stack:
            fn(model, x)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def slope_ms(fn, model, shape, dtype, *, reps: int = 5, k_big: int = 8,
             seed: int = 7) -> dict:
    """t1 and t_k_big (median ms over ``reps`` runs of distinct seeded
    inputs, after one warm-up run of each) and the slope per forward."""
    rng = np.random.default_rng(seed)
    device = next(model.parameters()).device

    def stacks(k, n):
        return [[torch.from_numpy(rng.integers(0, 255, shape).astype(
            np.uint8)).to(device, dtype) for _ in range(k)]
            for _ in range(n)]

    with torch.inference_mode():
        _runs_ms(fn, model, stacks(1, 1) + stacks(k_big, 1))
        t1 = _runs_ms(fn, model, stacks(1, reps))
        tk = _runs_ms(fn, model, stacks(k_big, reps))
    return {'t1_ms': t1, f't{k_big}_ms': tk,
            'ms_per_forward': (tk - t1) / (k_big - 1)}


def measure(target: dict, reps: int = 5) -> dict:
    """One row: counted FLOPs (and the counter's), the slope time, FLOP/s
    and MFU against the peak of the convolutions' dtype."""
    model, (shape, dtype) = target['model'], target['input']
    flops = layer_flops(target['count_fn'], model, target['input'])
    row = {'name': target['name'], 'flops': flops,
           'counter_flops': counter_flops(target['count_fn'], model,
                                          target['input']),
           'conv_dtype': target['conv_dtype'],
           'peak_flops': PEAK_FLOPS[target['conv_dtype']]}
    row.update(slope_ms(target['fn'], model, shape, dtype, reps=reps))
    per_s = flops / (row['ms_per_forward'] / 1e3)
    row['tflops_per_s'] = per_s / 1e12
    row['mfu'] = per_s / row['peak_flops']
    return row


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--reps', type=int, default=5)
    args = parser.parse_args(argv)

    from retargetvid_tpu_torch.bench import build_models, card_line
    from retargetvid_tpu_torch.device import resolve_device
    device = resolve_device(None)
    card = card_line()
    tn_model, un_model = build_models()
    tn_model.to(device)
    un_model.to(device).eval()
    rows = [measure(t, args.reps) for t in (unisal_target(un_model),
                                            transnet_target(tn_model))]
    for r in rows:
        print(f"{r['name']}: {r['flops'] / 1e9} GFLOP, "
              f"{r['ms_per_forward']} ms/fwd, {r['tflops_per_s']} TFLOP/s, "
              f"MFU {100 * r['mfu']}% of {r['conv_dtype']} "
              f"{r['peak_flops'] / 1e12} TFLOP/s (t1 {r['t1_ms']} ms, "
              f"t8 {r['t8_ms']} ms); {card}", flush=True)
    clip = clip_flops(un_model, tn_model)
    print(f"bench clip model FLOPs: UNISAL {clip['unisal_flops'] / 1e9} "
          f"GFLOP + TransNet {clip['transnet_fullseq_flops'] / 1e9} "
          f"(fullseq) / {clip['transnet_windowed_flops'] / 1e9} (windowed) "
          f"GFLOP; {clip['clip_fullseq_ms_at_peak']} / "
          f"{clip['clip_windowed_ms_at_peak']} ms at the peaks", flush=True)
    if torch.backends.cudnn.allow_tf32:
        print('UNISAL computes in float32 with TF32 convolutions; JAX\'s '
              'tools/mfu.py computes it in bf16.', flush=True)
    result = {'card': card, 'rows': rows, 'clip': clip}
    print(json.dumps(result), flush=True)
    return result


if __name__ == '__main__':
    main()
