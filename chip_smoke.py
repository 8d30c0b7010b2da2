#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Run from the root of a checkout.  It drives the port's main path -- the
one-shot clip program, raw frames to crop boxes -- at full model width and
fails (exit code != 0) if any phase fails:

  (a) build: compile every CUDA kernel of the port from ``csrc/`` (one
      ``nvcc`` per source, started together) and report the seconds;
  (b) kernel vs plain version: the saliency-postprocess kernel against its
      plain PyTorch version at the main path's shape (96, 140, 250) float32
      and at further shapes (one frame, ragged, larger than a cluster holds
      on chip, small), on wide-range inputs and on an unaligned view; all
      -inf frames give zeros, constant frames 255; the kernel must be
      bit-equal (it fails on any differing pixel and reports the count).
      Times beside the bytes bound: ``ms_device`` (cold L2) and
      ``ms_device_warm`` are device time per launch from a CUDA graph of 60
      launches replayed between two events, ``ms_call`` a single call with
      the host's enqueue in it; ``plain_ms`` is the plain version timed as
      ``ms_device``;
  (c) main path: ``OneShotClipProgram.run`` on the synthetic 480x360x640
      clip of ``bench.py`` (30 fps, 1:3 ratio), full-width TransNetV1 and
      UNISAL with seeded random weights, bf16; warm-up on seed 100, median
      of seeds 0..3, per-stage CUDA-event times; boxes checked against the
      frame and the destination size; the kernel's launches counted;
  (d) the kernel held on the path: the same clip in float32 (TF32 off),
      once through the kernel and once through the plain postprocess,
      must give identical boxes; and the port on the card agrees with the
      port on the CPU (which the test suite holds against the JAX package)
      on a small clip.

``--profile DIR`` adds one ``torch.profiler`` run of a main-path clip
(device busy time, idle share, kernel launches, the postprocess kernel's own
device time; the per-operator table goes to ``DIR/profile_main_path.txt``).

Each phase prints one JSON line carrying the card's name and power limit;
then a line with every kernel's record, the ``nvidia-smi`` name/power-limit
line, and last ``{"ok": true, "device": {...}}``.  Without a GPU, or
without the repository beside it, it exits with an error and prints no
result.
"""

import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

H100_BYTES_PER_S = 3.35e12            # HBM3, H100 SXM data sheet
H100_FP32_FLOPS = 67e12               # non-tensor float32, H100 SXM


def fail(msg: str):
    print(f'chip_smoke: FAIL: {msg}', file=sys.stderr)
    sys.exit(1)


def make_clip(n_frames=480, h=360, w=640, seed=0):
    """The synthetic clip of ``bench.py:make_clip`` (a moving Gaussian blob
    over seeded noise)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    frames = np.empty((n_frames, h, w, 3), np.uint8)
    cx = w * (0.2 + 0.6 * np.linspace(0, 1, n_frames))
    cy = h * (0.5 + 0.2 * np.sin(np.linspace(0, 8, n_frames)))
    base = rng.integers(0, 60, (h, w, 3)).astype(np.float32)
    for t in range(n_frames):
        blob = 200 * np.exp(-(((yy - cy[t]) ** 2 + (xx - cx[t]) ** 2)
                              / 2500.0))
        frames[t] = np.clip(base + blob[..., None], 0, 255).astype(np.uint8)
    return frames


def card_line() -> str:
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def emit(card: str, **fields):
    print(json.dumps({**fields, 'card': card}), flush=True)


def call_ms(fn, n: int = 25) -> float:
    """Median CUDA-event time of ``n`` single calls after 3 warm-up calls.

    The device is idle when each call starts, so this is the host's enqueue
    (argument checks, allocation, the launch) plus the device work: a
    per-call time, not a kernel time."""
    import torch
    for _ in range(3):
        fn()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, inputs, n: int = 60, reps: int = 15) -> float:
    """Device time per call: ``n`` calls of ``fn``, cycling over
    ``inputs``, captured into one CUDA graph and replayed between two
    events (median of ``reps`` replays, over ``n``).  The host's enqueue is
    not in it.  With inputs that together exceed the 50 MB L2, each call
    finds its input cold; with one input, warm."""
    import torch
    for x in inputs:
        fn(x)                                   # warm-up, outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n):
            fn(inputs[i % len(inputs)])
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    del graph
    return statistics.median(times)


def phase_build(card):
    from retargetvid_tpu_torch.kernels.build import BUILD_DIR, build_all
    t0 = time.perf_counter()
    build_all()
    emit(card, phase='build', seconds=time.perf_counter() - t0,
         build_dir=str(BUILD_DIR))


#: The main path's postprocess input: 81 picks padded to 96 frames of the
#: 140x250 saliency map.
MAIN_SHAPE = (96, 140, 250)
#: Further shapes the kernel is held at: one frame; a ragged frame
#: (hw % 4 != 0); frames larger than a cluster holds on chip; small frames.
EXTRA_SHAPES = ((1, 140, 250), (3, 37, 53), (2, 720, 1280), (5, 32, 128))
#: (scale, offset) of wide-range inputs ``randn * scale + offset`` at the
#: main shape, for the kernel's division: exp spanning many decades,
#: subnormal exp values beside normal maxima, and maxima above 2^125.
STRESS = ((20.0, 0.0), (1.0, -87.0), (3.0, -95.0), (30.0, 60.0))


def log_maps(shape, seed):
    """Seeded per-frame log-softmax maps on the card, with an all -inf
    frame (exp gives zeros) and a constant frame where there is room."""
    import torch
    t, h, w = shape
    gen = torch.Generator(device='cuda').manual_seed(seed)
    logits = torch.randn((t, h * w), generator=gen, device='cuda') * 2.0
    logp = torch.log_softmax(logits, dim=1).reshape(t, h, w)
    special = {}
    if t >= 2:
        special['neg_inf'] = 3 if t > 3 else t - 1
        logp[special['neg_inf']] = -float('inf')
    if t >= 3:
        special['constant'] = 5 if t > 5 else 1
        logp[special['constant']] = -float(np.log(h * w))
    return logp.contiguous(), special


def check_kernel_case(logp, special, label):
    """Kernel vs plain version on one input: differing pixels, max LSB, the
    -inf frame all zeros and the constant frame all 255.  Fails on any
    differing pixel (a max is exact in any order, so the kernel is
    bit-equal); returns the case's record."""
    import torch

    from retargetvid_tpu_torch.kernels.postprocess import (
        saliency_postprocess,
        saliency_postprocess_reference,
    )
    out = saliency_postprocess(logp)
    ref = saliency_postprocess_reference(logp)
    torch.cuda.synchronize()
    diff = (out.to(torch.int32) - ref.to(torch.int32)).abs()
    max_err = int(diff.max())
    n_diff = int((diff > 0).sum())
    if n_diff:
        fail(f'postprocess kernel, {label}: differs from its plain version '
             f'by {max_err} LSB in {n_diff} pixels')
    if 'neg_inf' in special and bool(out[special['neg_inf']].any()):
        fail(f'postprocess kernel, {label}: the all -inf frame is not all '
             f'zeros')
    if 'constant' in special and not bool(
            (out[special['constant']] == 255).all()):
        fail(f'postprocess kernel, {label}: the constant frame is not all '
             f'255')
    return {'case': label, 'shape': list(logp.shape), 'n_px': logp.numel(),
            'n_diff': n_diff, 'max_abs_err': max_err}


def phase_kernel(card):
    import torch

    from retargetvid_tpu_torch.kernels.postprocess import (
        launch_plan,
        saliency_postprocess,
        saliency_postprocess_reference,
    )
    logp, special = log_maps(MAIN_SHAPE, seed=0)
    cases = [check_kernel_case(logp, special, 'main')]
    for i, shape in enumerate(EXTRA_SHAPES):
        x, sp = log_maps(shape, seed=1 + i)
        cases.append(check_kernel_case(x, sp, 'x'.join(map(str, shape))))
    gen = torch.Generator(device='cuda').manual_seed(7)
    for scale, offset in STRESS:
        x = torch.randn(MAIN_SHAPE, generator=gen, device='cuda') * scale \
            + offset
        cases.append(check_kernel_case(x, {}, f'main, randn*{scale:g}'
                                              f'{offset:+g}'))
    # A contiguous input whose base is 4 bytes past a 16-byte boundary.
    flat = torch.empty(logp.numel() + 1, device='cuda')
    shifted = flat[1:].view(MAIN_SHAPE)
    shifted.copy_(logp)
    cases.append(check_kernel_case(shifted, special, 'main, unaligned'))
    del flat, shifted
    max_err = max(c['max_abs_err'] for c in cases)

    # Times: 6 inputs of 13.44 MB (80.6 MB together) cycle through the L2,
    # so each launch finds its input cold; the main path's input was just
    # written by UNISAL and is mostly warm.
    cold = [logp] + [log_maps(MAIN_SHAPE, seed=10 + i)[0] for i in range(5)]
    ms_dev = device_ms(saliency_postprocess, cold)
    ms_dev_warm = device_ms(saliency_postprocess, [logp])
    plain_ms = device_ms(saliency_postprocess_reference, cold)
    # Not the same function: one PyTorch kernel moving the same bytes (read
    # the float32 stack, write uint8), a yardstick for what the memory gives.
    cast_ms = device_ms(lambda x: x.to(torch.uint8), cold)
    ms_call = call_ms(lambda: saliency_postprocess(logp))
    plain_ms_call = call_ms(lambda: saliency_postprocess_reference(logp))
    del cold
    n_px = logp.numel()
    moved = n_px * 4 + n_px * 1                   # read f32, write uint8
    ops = n_px * 4                                # exp, max, divide, scale
    bound_ms = max(moved / H100_BYTES_PER_S, ops / H100_FP32_FLOPS) * 1e3
    bound_by = ('bytes' if moved / H100_BYTES_PER_S
                >= ops / H100_FP32_FLOPS else 'operations')
    t, h, w = MAIN_SHAPE
    plan = launch_plan(t, h * w)
    emit(card, phase='kernel', kernel='saliency_postprocess',
         shape=list(MAIN_SHAPE), plan=plan._asdict(), cases=cases,
         max_abs_err=max_err, tolerance='0 LSB', ms_device=ms_dev,
         ms_device_warm=ms_dev_warm, ms_call=ms_call, plain_ms=plain_ms,
         plain_ms_call=plain_ms_call, same_bytes_cast_ms=cast_ms,
         bound_ms=bound_ms, bound_by=bound_by,
         bound_share=bound_ms / ms_dev, bytes=moved)
    return {'name': 'saliency_postprocess', 'route': 'cuda',
            'source': 'retargetvid_tpu_torch/csrc/saliency_postprocess.cu',
            'replaces': 'retargetvid_tpu/ops/pallas_kernels.py:39',
            'cluster': plan.cluster,
            'max_abs_err': max_err, 'ms': ms_dev, 'ms_device': ms_dev,
            'ms_device_warm': ms_dev_warm, 'ms_call': ms_call,
            'plain_ms': plain_ms, 'bound_ms': bound_ms, 'bound_by': bound_by,
            # No single PyTorch call computes exp + per-frame max-normalize
            # + uint8 quantization.
            'library_ms': None}


def build_models(seed=0):
    from retargetvid_tpu_torch.models.init import seeded_init_
    from retargetvid_tpu_torch.models.transnet import TransNetV1
    from retargetvid_tpu_torch.models.unisal import UNISAL
    import torch
    tn = seeded_init_(TransNetV1(), seed)
    with torch.no_grad():
        # Random weights fire a "cut" on every frame; bias the head as
        # bench.py does so sampling runs its realistic every-skip regime.
        tn.dense2.bias.copy_(torch.tensor([5.0, -5.0]))
    un = seeded_init_(UNISAL(), seed + 1)
    return tn, un


def check_boxes(boxes, dest, h, w):
    if boxes.shape != (480, 4):
        fail(f'boxes shape {boxes.shape} != (480, 4)')
    x1, y1, x2, y2 = boxes.T
    if not ((x1 >= 0).all() and (y1 >= 0).all() and (x2 <= w).all()
            and (y2 <= h).all()):
        fail('a crop box lies outside the frame')
    if not ((x2 - x1 == dest['w_final']).all()
            and (y2 - y1 == dest['h_final']).all()):
        fail('a crop box does not have the destination size')


def phase_main_path(card, profile_dir=None):
    import torch

    from retargetvid_tpu_torch.config import sc_init_crop_params
    from retargetvid_tpu_torch.kernels.postprocess import saliency_postprocess
    from retargetvid_tpu_torch.ops.boxes import calc_dest_size
    from retargetvid_tpu_torch.pipeline.oneshot import (
        OneShotClipProgram,
        StageTimer,
    )
    h, w, fps = 360, 640, 30.0
    cp = sc_init_crop_params()
    cp['out_ratio'] = '1:3'
    dest = calc_dest_size(w, h, cp['out_ratio'])
    tn, un = build_models()
    program = OneShotClipProgram(tn, un, dtype=torch.bfloat16)
    kw = dict(fps=fps, w_final=dest['w_final'], h_final=dest['h_final'])

    warm = torch.from_numpy(make_clip(seed=100)).cuda()
    clips = [torch.from_numpy(make_clip(seed=s)).cuda() for s in range(4)]
    torch.cuda.synchronize()
    program.run(warm, cp, **kw)

    timer = StageTimer()
    program.timer = timer
    saliency_postprocess.launches = 0
    times, outs = [], []
    for clip in clips:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(program.run(clip, cp, **kw))
        times.append((time.perf_counter() - t0) * 1e3)
    launches = saliency_postprocess.launches
    program.timer = None
    if launches < 1:
        fail('the main path never launched the saliency_postprocess kernel')
    for out in outs:
        check_boxes(out['boxes'], dest, h, w)
        if not np.isfinite(out['dxs'][:480]).all():
            fail('non-finite smoothed centers')
    stages = {k: statistics.median(v) for k, v in timer.times_ms().items()}
    med = statistics.median(times)
    emit(card, phase='main_path', clip=[480, h, w], dtype='bfloat16',
         per_clip_ms=times, median_ms=med, frames_per_s=480 / med * 1e3,
         fc_sel=[o['fc_sel'] for o in outs],
         n_segments=[o['n_segments'] for o in outs],
         stage_median_ms=stages, postprocess_launches=launches)
    if profile_dir is not None:
        profile_clip(card, program, clips[0], cp, kw, Path(profile_dir))
    return launches


def profile_clip(card, program, clip, cp, kw, out_dir: Path):
    """``torch.profiler`` over one more clip: device busy time against the
    wall time, kernel launches, and the per-operator table (written to
    ``out_dir/profile_main_path.txt``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        program.run(clip, cp, **kw)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    avg = prof.key_averages()
    key = ('self_device_time_total'
           if hasattr(avg[0], 'self_device_time_total')
           else 'self_cuda_time_total')
    # The postprocess kernel's own device duration on the path (its input
    # just written by UNISAL), as the profiler records it.
    pp = [a for a in avg if 'saliency_postprocess' in a.key
          and getattr(a, key) > 0]
    pp_count = sum(a.count for a in pp)
    pp_us = sum(getattr(a, key) for a in pp) / pp_count if pp_count else None
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / 'profile_main_path.txt').write_text(
        f'{card}\n' + avg.table(sort_by=key, row_limit=40))
    emit(card, phase='profile', wall_ms=wall_ms, device_busy_ms=busy_ms,
         device_idle_share=1.0 - busy_ms / wall_ms,
         kernel_launches=len(kernels),
         postprocess_kernel_device_us=pp_us,
         postprocess_kernel_rows=[a.key for a in pp],
         table=str(out_dir / 'profile_main_path.txt'))


@contextlib.contextmanager
def plain_postprocess():
    """Route the path's postprocess through the plain PyTorch version."""
    from retargetvid_tpu_torch.kernels.postprocess import (
        saliency_postprocess_reference,
    )
    from retargetvid_tpu_torch.pipeline import fused
    saved = fused.saliency_postprocess
    fused.saliency_postprocess = saliency_postprocess_reference
    try:
        yield
    finally:
        fused.saliency_postprocess = saved


def small_clip(fc=48, h=72, w=128):
    yy, xx = np.mgrid[0:h, 0:w]
    frames = np.zeros((fc, h, w, 3), np.uint8)
    for t in range(fc):
        cx = w * (0.2 + 0.6 * t / fc) if t < fc // 2 else w * 0.75
        blob = 225 * np.exp(-(((yy - h * 0.5) ** 2 + (xx - cx) ** 2)
                              / 250.0))
        frames[t] = np.clip(blob[..., None] + (10 if t < fc // 2 else 60),
                            0, 255).astype(np.uint8)
    return frames


def phase_kernel_on_path(card):
    import torch

    from retargetvid_tpu_torch.config import sc_init_crop_params
    from retargetvid_tpu_torch.kernels.postprocess import saliency_postprocess
    from retargetvid_tpu_torch.models.init import seeded_init_
    from retargetvid_tpu_torch.models.transnet import TransNetV1
    from retargetvid_tpu_torch.models.unisal import UNISAL
    from retargetvid_tpu_torch.ops.boxes import calc_dest_size
    from retargetvid_tpu_torch.pipeline.oneshot import OneShotClipProgram
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cp = sc_init_crop_params()
    cp['out_ratio'] = '1:3'

    # Full clip, float32: kernel vs plain postprocess.
    dest = calc_dest_size(640, 360, cp['out_ratio'])
    kw = dict(fps=30.0, w_final=dest['w_final'], h_final=dest['h_final'])
    tn, un = build_models()
    program = OneShotClipProgram(tn, un, dtype=torch.float32)
    clip = torch.from_numpy(make_clip(seed=0)).cuda()
    before = saliency_postprocess.launches
    with_kernel = program.run(clip, cp, **kw)
    if saliency_postprocess.launches != before + 1:
        fail('the float32 run did not launch the kernel exactly once')
    with plain_postprocess():
        with_plain = program.run(clip, cp, **kw)
    if saliency_postprocess.launches != before + 1:
        fail('the plain run launched the kernel')
    n_box_diff = int((with_kernel['boxes'] != with_plain['boxes']).any(1)
                     .sum())
    if n_box_diff:
        fail(f'kernel and plain postprocess give different boxes on '
             f'{n_box_diff} frames')

    # Small clip: the port on the card vs the port on the CPU.
    fc, h, w = 48, 72, 128
    frames = small_clip(fc, h, w)
    dest_s = calc_dest_size(w, h, cp['out_ratio'])
    kw_s = dict(fps=30.0, w_final=dest_s['w_final'],
                h_final=dest_s['h_final'])
    tiny = dict(cnn_widen_factor=0.25, cnn_last_channel=None,
                rnn_input_channels=32, smoothing_ksize=11, smoothing_rank=4)
    outs = []
    for device in ('cuda', 'cpu'):
        tn_s = seeded_init_(TransNetV1(), 0)
        with torch.no_grad():
            tn_s.dense2.bias.copy_(torch.tensor([5.0, -5.0]))
        un_s = seeded_init_(UNISAL(**tiny), 1)
        outs.append(OneShotClipProgram(tn_s, un_s, dtype=torch.float32,
                                       device=device).run(frames, cp,
                                                          **kw_s))
    gpu, cpu = outs
    if (gpu['fc_sel'], gpu['n_segments']) != (cpu['fc_sel'],
                                              cpu['n_segments']):
        fail('small clip: sampling differs between card and CPU')
    box_err = int(np.abs(gpu['boxes'] - cpu['boxes']).max())
    if box_err > 1:
        fail(f'small clip: card and CPU boxes differ by {box_err} px')
    emit(card, phase='kernel_on_path', dtype='float32', tf32=False,
         boxes_differing_frames=n_box_diff,
         fc_sel=with_kernel['fc_sel'], n_segments=with_kernel['n_segments'],
         small_clip_card_vs_cpu_max_box_px=box_err, tolerance_px=1)


def main():
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--profile', metavar='DIR', default=None,
                        help='also profile one main-path clip with '
                             'torch.profiler and write the table to DIR')
    args = parser.parse_args()
    repo = Path(__file__).resolve().parent
    if not (repo / 'retargetvid_tpu_torch' / 'csrc').is_dir():
        fail('retargetvid_tpu_torch/ not found beside chip_smoke.py; run it '
             'from a checkout of the repository')
    sys.path.insert(0, str(repo))
    import torch
    if not torch.cuda.is_available():
        fail('torch.cuda.is_available() is False: this smoke test needs a '
             'CUDA GPU')
    card = card_line()
    phase_build(card)
    record = phase_kernel(card)
    record['launches'] = phase_main_path(card, args.profile)
    phase_kernel_on_path(card)
    if 'jax' in sys.modules:
        fail('jax was imported')
    print(json.dumps({'kernels': [record]}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
