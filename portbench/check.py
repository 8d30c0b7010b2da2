"""The comparison that decides a run's ``correct``.

For each sampled pool clip the reference runs once, in float32 with TF32
off, and every output the window produced for that clip is compared with
it by the path's ``compare``; each number keeps its worst reading, which
must not pass the configuration's limit for it.  With ``control`` the
control (the reference in the precision below the configuration's) is
compared the same way and keeps its least reading.
"""

from __future__ import annotations

import collections
import contextlib

import torch


def run_check(adapter, outputs: dict, clips: list,
              control: bool = False) -> dict:
    limits = adapter.cfg['limits']
    worst = collections.defaultdict(float)
    ctrl = collections.defaultdict(lambda: float('inf'))
    with tf32(False):
        for idx, clip in zip(sorted(outputs), clips):
            expect = adapter.reference(clip)
            for out in outputs[idx]:
                got = adapter.compare(adapter.normalize(out), expect)
                for k, v in got.items():
                    worst[k] = max(worst[k], v)
            if control:
                got = adapter.compare(adapter.reference(clip, control=True),
                                      expect)
                for k, v in got.items():
                    ctrl[k] = min(ctrl[k], v)
    checks = {k: {'value': worst[k], 'limit': float(limits[k])}
              for k in limits}
    if control:
        for k in limits:
            checks[k]['control'] = ctrl[k]
        checks['readings'] = {k: {'value': worst[k], 'control': ctrl[k]}
                              for k in sorted(set(worst) | set(ctrl))}
    return checks


MAP_GAPS = ('map_mean_gap', 'map_tf32_gap', 'map_gap_ratio')


@contextlib.contextmanager
def tf32(convolutions: bool):
    """cuDNN's TF32 for convolutions on or off inside the block; TF32
    matmuls off (PyTorch's default)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = convolutions
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def map_gaps(got, expect: dict) -> dict:
    """Gaps of a uint8 map stack from the float32 reference's
    (``expect['maps']``), in steps, averaged over every pixel:
    ``map_mean_gap``; ``map_tf32_gap``, the gap the reference itself shows
    with TF32 convolutions (``expect['maps_tf32']``), and their ratio
    ``map_gap_ratio``, floored at one step over the stack.  With seeded
    weights the plain gap moves with the weights' sensitivity from seed to
    seed; the ratio does not."""
    ref = expect['maps'].to(torch.int16)
    gap = (got.to(ref.device, torch.int16) - ref).abs().double().mean()
    base = (expect['maps_tf32'].to(torch.int16) - ref).abs().double().mean()
    return {'map_mean_gap': float(gap), 'map_tf32_gap': float(base),
            'map_gap_ratio': float(gap / max(float(base), 1 / ref.numel()))}
