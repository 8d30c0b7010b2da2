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
  (c) main path: ``OneShotClipProgram.run`` with the full-sequence
      TransNet plan on the synthetic 480x360x640 clip of ``bench.py``
      (30 fps, 1:3 ratio), full-width TransNetV1 and UNISAL with seeded
      random weights, bf16; warm-up on seed 100, median of seeds 0..3,
      per-stage CUDA-event times; boxes checked against the frame and the
      destination size; the kernel's launches counted (one per clip);
  (e) windowed plan: the same with the 100/50 TransNet window plan (the
      program's default); the picks and shots must equal the main path's;
  (g) multi-ratio: ``dispatch_multi`` serving 1:3 and 3:1 from one pass
      (full-sequence plan, bf16), timed beside the two ``run`` calls it
      replaces; one kernel launch per ``dispatch_multi``;
  (f) two-dispatch: a 12-shot clip (a hard cut every 40 frames, found by a
      frame-difference stand-in for TransNet) is refused by the one-shot
      program (12 shots > ``s_pad`` 8) and served by the two-dispatch path
      of ``bench.py``: the ingest resizes and the real windowed
      ``TransNetPredictor`` forward (timed; the stand-in's profile drives
      the rest), host sampling and scenes, ``FusedClipProgram.run``;
  (i) ISM preset: (c), (g) and (f) again under the ISM-2021 "best
      settings" (``sc_init_crop_params(use_best_settings=True)``: the
      factor-4 filter roundtrip, focus stability, Savitzky-Golay, the
      order-2 Butterworth), each with its launches, the focus jump pairs
      and the frames frozen per clip;
  (d) exactness, in float32 with TF32 off, under the ICIP and the ISM
      preset: the main-path clip once through the kernel and once through
      the plain postprocess gives identical boxes; each ratio of
      ``dispatch_multi`` gives the boxes of that ratio's ``run``; the port
      on the card agrees with the port on the CPU (which the test suite
      holds against the JAX package) within 1 px on a small clip, by the
      full-sequence plan, the window plan and the two-dispatch path, and
      by the full-sequence plan under each further setting (border
      detection, time shift, argmax center, adaptive linking, cubic and
      nearest factor-4 downscales); the ISM geometry chain on a saliency
      volume whose focus jumps gives the same jump pairs and frozen spans
      on the card and on the CPU, and boxes within 1 px; and the windowed
      one-shot probabilities equal ``TransNetPredictor``'s within 1e-5.

``--profile DIR`` adds one ``torch.profiler`` run of a main-path clip and
one of an ISM clip (device busy time, idle share, kernel launches, the
postprocess kernel's own device time; the per-operator tables go to
``DIR/profile_main_path.txt`` and ``DIR/profile_ism_main_path.txt``).

Each phase prints one JSON line carrying the card's name and power limit;
then a line with every kernel's record (with its launches on each path),
the ``nvidia-smi`` name/power-limit line, and last ``{"ok": true,
"device": {...}}``.  Without a GPU, or
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


def make_clip(n_frames=480, h=360, w=640, seed=0, shot_len=None):
    """The synthetic clip of ``bench.py:make_clip`` (a moving Gaussian blob
    over seeded noise); with ``shot_len``, the noise is drawn anew every
    ``shot_len`` frames: a hard cut."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    frames = np.empty((n_frames, h, w, 3), np.uint8)
    cx = w * (0.2 + 0.6 * np.linspace(0, 1, n_frames))
    cy = h * (0.5 + 0.2 * np.sin(np.linspace(0, 8, n_frames)))
    base = rng.integers(0, 60, (h, w, 3)).astype(np.float32)
    for t in range(n_frames):
        if shot_len and t and t % shot_len == 0:
            base = rng.integers(0, 60, (h, w, 3)).astype(np.float32)
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


def cut_detector():
    """A TransNet stand-in: probability 1 on a frame whose mean absolute
    difference from the previous frame exceeds 10 (a hard cut), else 0."""
    import torch

    class CutDetector(torch.nn.Module):
        def forward(self, frames):                   # (B, T, 27, 48, 3)
            x = frames.float()
            d = (x[:, 1:] - x[:, :-1]).abs().mean(dim=(2, 3, 4))
            return torch.nn.functional.pad((d > 10.0).float(), (1, 0))

    return CutDetector()


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


class Bench:
    """The bench.py clip, crop parameters, destinations and full-width
    models shared by the bf16 phases."""

    def __init__(self):
        import torch

        from retargetvid_tpu_torch.config import sc_init_crop_params
        from retargetvid_tpu_torch.ops.boxes import calc_dest_size
        self.h, self.w, self.fps = 360, 640, 30.0
        self.cp = sc_init_crop_params()
        self.cp['out_ratio'] = '1:3'
        self.dests = [calc_dest_size(self.w, self.h, r)
                      for r in ('1:3', '3:1')]
        self.dest = self.dests[0]
        self.kw = dict(fps=self.fps, w_final=self.dest['w_final'],
                       h_final=self.dest['h_final'])
        self.tn, self.un = build_models()
        self.warm = torch.from_numpy(make_clip(seed=100)).cuda()
        self.clips = [torch.from_numpy(make_clip(seed=s)).cuda()
                      for s in range(4)]
        torch.cuda.synchronize()

    def check(self, out, dest=None):
        check_boxes(out['boxes'], dest or self.dest, self.h, self.w)
        if not np.isfinite(out['dxs'][:480]).all():
            fail('non-finite smoothed centers')


def drive(run, warm, clips, program=None):
    """``run`` on the warm-up clip, then on each clip with the kernel's
    launch count set to 0 just before and read just after: per-clip ms,
    outputs, launches and, with ``program``, its median stage times."""
    import torch

    from retargetvid_tpu_torch.kernels.postprocess import saliency_postprocess
    from retargetvid_tpu_torch.pipeline.oneshot import StageTimer
    run(warm)
    timer = StageTimer()
    if program is not None:
        program.timer = timer
    saliency_postprocess.launches = 0
    times, outs = [], []
    for clip in clips:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(run(clip))
        times.append((time.perf_counter() - t0) * 1e3)
    launches = saliency_postprocess.launches
    if program is not None:
        program.timer = None
    stages = {k: statistics.median(v) for k, v in timer.times_ms().items()}
    return times, outs, launches, stages


def focus_spans(jumps, n, cp, fps):
    """The focus jumps among the first ``n`` jump scores (index >= 1) and
    the spans focus stability froze; returns (jump indices, spans, frames
    in the spans)."""
    from retargetvid_tpu_torch.ops.temporal import frozen_spans
    inds = [i for i in range(1, n) if jumps[i] < cp['foces_stab_t']]
    spans = frozen_spans(inds, fc_sel=n, skip=cp['skip'], fps=fps,
                         stab_secs=cp['foces_stab_s'])
    return inds, spans, len(set().union(*(range(a, b) for a, b in spans)))


def focus_stats(outs, cp, fps):
    """Per clip: the focus-jump pairs and the frozen frames."""
    pairs, frozen = [], []
    for out in outs:
        n = out['fc_sel'] if 'fc_sel' in out else len(out['dx'])
        inds, _, n_frozen = focus_spans(out['jumps'], int(n), cp, fps)
        pairs.append(max(len(inds) - 1, 0))
        frozen.append(n_frozen)
    return {'jump_pairs': pairs, 'frozen_frames': frozen}


def ism_params():
    from retargetvid_tpu_torch.config import sc_init_crop_params
    cp = sc_init_crop_params(use_best_settings=True)
    cp['out_ratio'] = '1:3'
    return cp


def expect_launches(path, launches, n):
    if launches != n:
        fail(f'{path}: {launches} saliency_postprocess launches for {n} '
             f'clips (expected one per clip)')


def phase_main_path(card, bench, profile_dir=None):
    import torch

    from retargetvid_tpu_torch.pipeline.oneshot import OneShotClipProgram
    program = OneShotClipProgram(bench.tn, bench.un, dtype=torch.bfloat16,
                                 tn_fullseq=True)
    times, outs, launches, stages = drive(
        lambda c: program.run(c, bench.cp, **bench.kw), bench.warm,
        bench.clips, program)
    expect_launches('main path', launches, len(bench.clips))
    for out in outs:
        bench.check(out)
    med = statistics.median(times)
    emit(card, phase='main_path', clip=[480, bench.h, bench.w],
         dtype='bfloat16', tn_plan='fullseq', per_clip_ms=times,
         median_ms=med, frames_per_s=480 / med * 1e3,
         fc_sel=[o['fc_sel'] for o in outs],
         n_segments=[o['n_segments'] for o in outs],
         stage_median_ms=stages, postprocess_launches=launches)
    if profile_dir is not None:
        profile_clip(card, program, bench.clips[0], bench.cp, bench.kw,
                     Path(profile_dir), 'main_path')
    return program, outs, stages, launches


def phase_ism(card, bench, profile_dir=None):
    """The main path under the ISM preset; returns the program and its
    launches."""
    import torch

    from retargetvid_tpu_torch.pipeline.oneshot import OneShotClipProgram
    cp = ism_params()
    program = OneShotClipProgram(bench.tn, bench.un, dtype=torch.bfloat16,
                                 tn_fullseq=True)
    times, outs, launches, stages = drive(
        lambda c: program.run(c, cp, **bench.kw), bench.warm, bench.clips,
        program)
    expect_launches('ISM main path', launches, len(bench.clips))
    for out in outs:
        bench.check(out)
    med = statistics.median(times)
    emit(card, phase='ism_main_path', preset='ISM-2021',
         clip=[480, bench.h, bench.w], dtype='bfloat16', tn_plan='fullseq',
         per_clip_ms=times, median_ms=med, frames_per_s=480 / med * 1e3,
         fc_sel=[o['fc_sel'] for o in outs],
         n_segments=[o['n_segments'] for o in outs],
         **focus_stats(outs, cp, bench.fps), boxes_in_frame_at_dest=True,
         stage_median_ms=stages, postprocess_launches=launches)
    if profile_dir is not None:
        profile_clip(card, program, bench.clips[0], cp, bench.kw,
                     Path(profile_dir), 'ism_main_path')
    return program, launches


def phase_windowed(card, bench, main_outs, main_stages):
    import torch

    from retargetvid_tpu_torch.pipeline.oneshot import OneShotClipProgram
    program = OneShotClipProgram(bench.tn, bench.un, dtype=torch.bfloat16)
    if program.tn_fullseq:
        fail('the one-shot program does not default to the window plan')
    times, outs, launches, stages = drive(
        lambda c: program.run(c, bench.cp, **bench.kw), bench.warm,
        bench.clips, program)
    expect_launches('windowed plan', launches, len(bench.clips))
    for out, main in zip(outs, main_outs):
        bench.check(out)
        if (out['fc_sel'], out['n_segments']) != (main['fc_sel'],
                                                  main['n_segments']):
            fail('windowed plan: picks or shots differ from the '
                 'full-sequence plan on the same clip')
    med = statistics.median(times)
    emit(card, phase='windowed_plan', clip=[480, bench.h, bench.w],
         dtype='bfloat16', tn_plan='windowed', per_clip_ms=times,
         median_ms=med, frames_per_s=480 / med * 1e3,
         fc_sel=[o['fc_sel'] for o in outs],
         n_segments=[o['n_segments'] for o in outs],
         stage_median_ms=stages,
         transnet_stage_windowed_over_fullseq=(stages['transnet']
                                               / main_stages['transnet']),
         postprocess_launches=launches)
    return launches


def phase_multi_ratio(card, bench, program, cp=None, phase='multi_ratio'):
    """``dispatch_multi`` for both ratios and the two ``run`` calls it
    replaces, in turns on each clip (multi first on even clips, runs first
    on odd ones); the launch count is set to 0 before each and read after.
    ``cp`` defaults to the bench's ICIP parameters."""
    import torch

    from retargetvid_tpu_torch.kernels.postprocess import saliency_postprocess
    from retargetvid_tpu_torch.pipeline.oneshot import StageTimer
    cp = cp or bench.cp
    dests = [(d['w_final'], d['h_final']) for d in bench.dests]
    kw = dict(fps=bench.fps)

    def multi(clip):
        return program.collect_multi(program.dispatch_multi(
            clip, cp, dests=dests, **kw))

    def runs(clip):
        return [program.run(clip, cp, w_final=wf, h_final=hf, **kw)
                for wf, hf in dests]

    multi(bench.warm)
    runs(bench.warm)
    timer = StageTimer()
    ms = {'multi': [], 'runs': []}
    outs = {'multi': [], 'runs': []}
    launches = {'multi': 0, 'runs': 0}
    for i, clip in enumerate(bench.clips):
        order = ('multi', 'runs') if i % 2 == 0 else ('runs', 'multi')
        for name in order:
            program.timer = timer if name == 'multi' else None
            torch.cuda.synchronize()
            saliency_postprocess.launches = 0
            t0 = time.perf_counter()
            outs[name].append((multi if name == 'multi' else runs)(clip))
            ms[name].append((time.perf_counter() - t0) * 1e3)
            launches[name] += saliency_postprocess.launches
    program.timer = None
    expect_launches(phase, launches['multi'], len(bench.clips))
    expect_launches(f'{phase}, two runs', launches['runs'],
                    2 * len(bench.clips))
    same = 0
    for per_ratio, per_run in zip(outs['multi'], outs['runs']):
        for out, single, dest in zip(per_ratio, per_run, bench.dests):
            bench.check(out, dest)
            bench.check(single, dest)
            same += int(np.array_equal(out['boxes'], single['boxes']))
    med, run_med = (statistics.median(ms['multi']),
                    statistics.median(ms['runs']))
    extra = focus_stats([o[0] for o in outs['multi']], cp, bench.fps) \
        if cp['focus_stability'] else {}
    emit(card, phase=phase, clip=[480, bench.h, bench.w],
         dtype='bfloat16', tn_plan='fullseq', ratios=['1:3', '3:1'],
         **extra, per_clip_ms=ms['multi'], median_ms=med,
         stage_median_ms={k: statistics.median(v)
                          for k, v in timer.times_ms().items()},
         two_runs_per_clip_ms=ms['runs'], two_runs_median_ms=run_med,
         multi_over_two_runs=med / run_med,
         bf16_ratio_boxes_equal_to_run=f'{same} of {2 * len(bench.clips)}',
         postprocess_launches=launches['multi'])
    return launches['multi']


def two_dispatch(clip, cp, kw, resize, fused, profile, real=None):
    """The two-dispatch path of ``bench.py``: resizes (+ the real TransNet
    forward, timed but unused, as bench.py does), the probabilities of the
    ``profile`` predictor (made before the clock starts), host sampling and
    scenes, ``FusedClipProgram.run``.  Returns the outputs, the shot count
    and (ingest, host, fused) ms."""
    import torch

    from retargetvid_tpu_torch.ops.scenes import (
        fix_scene_bounds,
        predictions_to_scenes,
        scenes_to_selected,
    )
    from retargetvid_tpu_torch.pipeline.ingest import (
        TRANS_THRESHOLD,
        sample_frames,
    )
    fc = int(clip.shape[0])
    with torch.inference_mode():
        probs = profile(resize(clip)[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        tn_frames, sal = resize(clip)
    if real is not None:
        real(tn_frames)
    t1 = time.perf_counter()
    selected, true_inds, m2o = sample_frames(fc, probs, cp['skip'], fc)
    seg = fix_scene_bounds(predictions_to_scenes(probs, TRANS_THRESHOLD), fc)
    seg_sel = scenes_to_selected(seg, m2o)
    t2 = time.perf_counter()
    out = fused.run(sal, selected, true_inds, seg, seg_sel, cp, fc=fc, **kw)
    t3 = time.perf_counter()
    return out, len(seg), [(t1 - t0) * 1e3, (t2 - t1) * 1e3,
                           (t3 - t2) * 1e3]


def phase_two_dispatch(card, bench, cp=None, phase='two_dispatch'):
    """The 12-shot clip, refused by the one-shot program and served by the
    two-dispatch path; ``cp`` defaults to the bench's ICIP parameters."""
    import torch

    from retargetvid_tpu_torch.models.transnet import TransNetPredictor
    from retargetvid_tpu_torch.pipeline.fused import FusedClipProgram
    from retargetvid_tpu_torch.pipeline.ingest import _resize_kernel, sal_dims
    from retargetvid_tpu_torch.kernels.postprocess import saliency_postprocess
    from retargetvid_tpu_torch.pipeline.oneshot import (
        OneShotClipProgram,
        StageTimer,
    )
    h, w = bench.h, bench.w
    standin = cut_detector()
    warm = torch.from_numpy(make_clip(seed=100, shot_len=40)).cuda()
    clips = [torch.from_numpy(make_clip(seed=s, shot_len=40)).cuda()
             for s in range(4)]
    cp = cp or bench.cp
    try:
        OneShotClipProgram(standin, bench.un, dtype=torch.bfloat16).run(
            warm, cp, **bench.kw)
    except ValueError as exc:
        refusal = str(exc)
    else:
        fail('the one-shot program served a 12-shot clip')

    resize = _resize_kernel(h, w, *sal_dims(w, h, bench.cp['max_input_d']))
    profile = TransNetPredictor(standin)
    real = TransNetPredictor(bench.tn)            # window plan, bf16
    fused = FusedClipProgram(bench.un, dtype=torch.bfloat16)
    kw = dict(bench.kw, h_orig=h, w_orig=w)
    two_dispatch(warm, cp, kw, resize, fused, profile, real)
    timer = StageTimer()
    fused.timer = timer
    saliency_postprocess.launches = 0
    outs, shots, parts = [], [], []
    for clip in clips:
        out, n_seg, ms = two_dispatch(clip, cp, kw, resize, fused,
                                      profile, real)
        outs.append(out)
        shots.append(n_seg)
        parts.append(ms)
    launches = saliency_postprocess.launches
    fused.timer = None
    expect_launches(phase, launches, len(clips))
    if shots != [12] * len(clips):
        fail(f'{phase}: {shots} shots, expected 12 per clip')
    for out in outs:
        bench.check(out)
    stages = {k: statistics.median(v) for k, v in timer.times_ms().items()}
    names = ('ingest_and_transnet', 'host_sampling', 'fused')
    per_part = {n: [p[i] for p in parts] for i, n in enumerate(names)}
    totals = [sum(p) for p in parts]
    extra = focus_stats(outs, cp, bench.fps) if cp['focus_stability'] \
        else {}
    emit(card, phase=phase, clip=[480, h, w], dtype='bfloat16',
         tn_plan='windowed', shots=shots, refused_by_oneshot=refusal,
         **extra,
         fc_sel=[int(len(o['dx'])) for o in outs],
         per_clip_ms=totals, median_ms=statistics.median(totals),
         part_median_ms={n: statistics.median(v)
                         for n, v in per_part.items()},
         fused_stage_median_ms=stages, postprocess_launches=launches)
    return launches


def profile_clip(card, program, clip, cp, kw, out_dir: Path, name: str):
    """``torch.profiler`` over one more clip: device busy time against the
    wall time, kernel launches, and the per-operator table (written to
    ``out_dir/profile_<name>.txt``)."""
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
    table = out_dir / f'profile_{name}.txt'
    table.write_text(f'{card}\n' + avg.table(sort_by=key, row_limit=40))
    emit(card, phase='profile', path=name, wall_ms=wall_ms,
         device_busy_ms=busy_ms,
         device_idle_share=1.0 - busy_ms / wall_ms,
         kernel_launches=len(kernels),
         postprocess_kernel_device_us=pp_us,
         postprocess_kernel_rows=[a.key for a in pp],
         table=str(table))


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


@contextlib.contextmanager
def exact_float32():
    """cuDNN and cuBLAS without TF32, restored afterwards."""
    import torch
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def small_clip(fc=48, h=72, w=128):
    """A blob that moves, then stops on a brighter background (a cut at
    frame 24 for the stand-in detector)."""
    yy, xx = np.mgrid[0:h, 0:w]
    frames = np.zeros((fc, h, w, 3), np.uint8)
    for t in range(fc):
        cx = w * (0.2 + 0.6 * t / fc) if t < fc // 2 else w * 0.75
        blob = 225 * np.exp(-(((yy - h * 0.5) ** 2 + (xx - cx) ** 2)
                              / 250.0))
        frames[t] = np.clip(blob[..., None] + (10 if t < fc // 2 else 60),
                            0, 255).astype(np.uint8)
    return frames


def small_models(device):
    """Full-width TransNet (head biased) and the narrow UNISAL of the test
    suite, from the same seeds on every device."""
    import torch

    from retargetvid_tpu_torch.models.init import seeded_init_
    from retargetvid_tpu_torch.models.transnet import TransNetV1
    from retargetvid_tpu_torch.models.unisal import UNISAL
    tiny = dict(cnn_widen_factor=0.25, cnn_last_channel=None,
                rnn_input_channels=32, smoothing_ksize=11, smoothing_rank=4)
    tn = seeded_init_(TransNetV1(), 0)
    with torch.no_grad():
        tn.dense2.bias.copy_(torch.tensor([5.0, -5.0]))
    return tn.to(device), seeded_init_(UNISAL(**tiny), 1).to(device)


def small_clip_paths(device, models, frames, cp, all_plans=True,
                     t_border=-1):
    """The small clip through the full-sequence plan and, with
    ``all_plans``, the window plan and the two-dispatch path (driven by the
    stand-in's cut) on ``device``, float32."""
    import torch

    from retargetvid_tpu_torch.models.transnet import TransNetPredictor
    from retargetvid_tpu_torch.ops.boxes import calc_dest_size
    from retargetvid_tpu_torch.pipeline.fused import FusedClipProgram
    from retargetvid_tpu_torch.pipeline.ingest import _resize_kernel, sal_dims
    from retargetvid_tpu_torch.pipeline.oneshot import OneShotClipProgram
    tn, un = models
    h, w = frames.shape[1:3]
    dest = calc_dest_size(w, h, cp['out_ratio'])
    kw = dict(fps=30.0, w_final=dest['w_final'], h_final=dest['h_final'])
    outs = {}
    for plan, fullseq in (('fullseq', True), ('windowed', False)):
        if fullseq or all_plans:
            outs[plan] = OneShotClipProgram(
                tn, un, dtype=torch.float32, tn_fullseq=fullseq,
                t_border=t_border, device=device).run(frames, cp, **kw)
    if all_plans:
        resize = _resize_kernel(h, w, *sal_dims(w, h, cp['max_input_d']))
        profile = TransNetPredictor(cut_detector(), device=device)
        fused = FusedClipProgram(un, dtype=torch.float32, t_border=t_border,
                                 device=device)
        out, n_seg, _ = two_dispatch(torch.from_numpy(frames).to(device), cp,
                                     dict(kw, h_orig=h, w_orig=w), resize,
                                     fused, profile)
        out['fc_sel'], out['n_segments'] = len(out['dx']), n_seg
        outs['two_dispatch'] = out
    return outs


#: Further settings held card vs CPU on the small clip, over the ICIP
#: preset: (crop-parameter changes, the programs' ``t_border``).
SETTINGS = {
    't_border=10': ({}, 10),
    'shift_time=5': ({'shift_time': 5}, -1),
    'com_km=False': ({'com_km': False}, -1),
    'tpu_adaptive_link': ({'tpu_adaptive_link': True}, -1),
    'resize_type=2, factor 4': ({'resize_factor': 4, 'resize_type': 2}, -1),
    'resize_type=3, factor 4': ({'resize_factor': 4, 'resize_type': 3}, -1),
}


def card_vs_cpu(label, gpu, cpu):
    """Largest box difference (px) per path; fails beyond 1 px or on
    different picks or shots."""
    box_err = {}
    for path in gpu:
        if (gpu[path]['fc_sel'], gpu[path]['n_segments']) != (
                cpu[path]['fc_sel'], cpu[path]['n_segments']):
            fail(f'small clip, {label}, {path}: sampling differs between '
                 f'card and CPU')
        box_err[path] = int(np.abs(gpu[path]['boxes']
                                   - cpu[path]['boxes']).max())
        if box_err[path] > 1:
            fail(f'small clip, {label}, {path}: card and CPU boxes differ '
                 f'by {box_err[path]} px')
    return box_err


def focus_volume():
    """The ISM geometry's focus case: a 150-frame clip sampled every 6
    frames with cuts after frames 59 and 64, and uint8 saliency on its 26
    picks (a blob that sweeps right, jumps back at the cut and sweeps left,
    over 2% speckle, one empty map), as ``tests/test_torch_geometry.py``
    builds it.  Returns the volume padded to 32 picks and the chain's
    padded arguments."""
    import torch

    from retargetvid_tpu_torch.ops.scenes import (
        fix_scene_bounds,
        predictions_to_scenes,
        scenes_to_selected,
    )
    from retargetvid_tpu_torch.pipeline.ingest import sample_frames
    fc, h, w, t_pad, s_pad = 150, 140, 250, 32, 4
    probs = np.zeros(fc, np.float32)
    probs[[59, 64]] = 0.9
    _, true_inds, m2o = sample_frames(fc, probs, 6, fc)
    seg = fix_scene_bounds(predictions_to_scenes(probs, 0.1), fc)
    seg_sel = scenes_to_selected(seg, m2o)
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:h, 0:w]
    t_sel = len(true_inds)
    maps = np.zeros((t_pad, h, w), np.float32)
    for i, f in enumerate(true_inds):
        cx = w * (0.2 + 0.6 * f / fc) if f < 60 else w * (0.8 - 0.4 * f / fc)
        cy = h * (0.5 + 0.2 * np.sin(f / 10.0))
        maps[i] = 250 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 400.0)
        maps[i] += (rng.random((h, w)) < 0.02) * rng.uniform(0, 255, (h, w))
    maps[5] = 0.0
    ti = np.zeros(t_pad, np.int64)
    ti[:t_sel] = true_inds
    ti[t_sel:] = ti[t_sel - 1] + np.arange(1, t_pad - t_sel + 1)

    def pad_seg(arr, col):
        out = np.zeros(s_pad, np.int64)
        out[:len(seg)] = np.asarray(arr)[:, col]
        return torch.from_numpy(out)

    return (torch.from_numpy(np.clip(maps, 0, 255).astype(np.uint8)),
            torch.from_numpy(np.arange(t_pad) < t_sel), t_sel,
            torch.from_numpy(ti), pad_seg(seg, 0), pad_seg(seg, 1),
            pad_seg(seg_sel, 0), pad_seg(seg_sel, 1), len(seg)), fc


def ism_geometry_card_vs_cpu(cp):
    """The geometry chain under ISM on :func:`focus_volume`, on the card
    and on the CPU: the jump pairs and frozen spans must be equal and
    present, the boxes within 1 px.  Returns the record."""
    import torch

    from retargetvid_tpu_torch.pipeline.geometry import (
        GeometryConfig,
        geometry_pipeline,
    )
    args, fc = focus_volume()
    t_sel = args[2]
    res = {}
    for dev in ('cuda', 'cpu'):
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        out = geometry_pipeline(
            *[a.to(dev) if torch.is_tensor(a) else a for a in args], fc,
            zero, zero, zero, zero, cfg=GeometryConfig.from_crop_params(cp),
            fps=30.0, h_orig=360, w_orig=640, w_final=120, h_final=360,
            t_out=160)
        res[dev] = (out['boxes'].cpu().numpy()[:fc], *focus_spans(
            out['jumps'].cpu().numpy(), t_sel, cp, 30.0))
    (gb, gi, gs, n_frozen), (cb, ci, cs, _) = res['cuda'], res['cpu']
    if (gi, gs) != (ci, cs) or len(gi) < 2 or not gs:
        fail(f'ISM geometry: jumps {gi} / spans {gs} on the card, {ci} / '
             f'{cs} on the CPU')
    box_err = int(np.abs(gb - cb).max())
    if box_err > 1:
        fail(f'ISM geometry: card and CPU boxes differ by {box_err} px')
    return {'jump_pairs': len(gi) - 1, 'frozen_spans': gs,
            'frozen_frames': n_frozen, 'max_box_px': box_err}


def phase_exact(card):
    import torch

    from retargetvid_tpu_torch.config import sc_init_crop_params
    from retargetvid_tpu_torch.kernels.postprocess import saliency_postprocess
    from retargetvid_tpu_torch.models.transnet import TransNetPredictor
    from retargetvid_tpu_torch.ops.boxes import calc_dest_size
    from retargetvid_tpu_torch.pipeline.ingest import _resize_kernel, sal_dims
    from retargetvid_tpu_torch.pipeline.oneshot import OneShotClipProgram
    icip = sc_init_crop_params()
    icip['out_ratio'] = '1:3'
    presets = {'icip': icip, 'ism': ism_params()}
    clip = torch.from_numpy(make_clip(seed=0)).cuda()
    h, w = int(clip.shape[1]), int(clip.shape[2])
    dests = [calc_dest_size(w, h, r) for r in ('1:3', '3:1')]
    kw = dict(fps=30.0, w_final=dests[0]['w_final'],
              h_final=dests[0]['h_final'])
    tn, un = build_models()
    fullseq = OneShotClipProgram(tn, un, dtype=torch.float32,
                                 tn_fullseq=True)
    windowed = OneShotClipProgram(tn, un, dtype=torch.float32)

    n_box_diff, fc_sel, n_segments = {}, {}, {}
    for name, cp in presets.items():
        # Kernel vs plain postprocess on the main path.
        before = saliency_postprocess.launches
        with_kernel = fullseq.run(clip, cp, **kw)
        if saliency_postprocess.launches != before + 1:
            fail(f'{name}: the float32 run did not launch the kernel '
                 f'exactly once')
        with plain_postprocess():
            with_plain = fullseq.run(clip, cp, **kw)
        if saliency_postprocess.launches != before + 1:
            fail(f'{name}: the plain run launched the kernel')
        n_box_diff[name] = int((with_kernel['boxes'] != with_plain['boxes'])
                               .any(1).sum())
        if n_box_diff[name]:
            fail(f'{name}: kernel and plain postprocess give different '
                 f'boxes on {n_box_diff[name]} frames')
        fc_sel[name] = with_kernel['fc_sel']
        n_segments[name] = with_kernel['n_segments']

        # dispatch_multi vs each ratio's run.
        before = saliency_postprocess.launches
        multi = fullseq.collect_multi(fullseq.dispatch_multi(
            clip, cp, fps=30.0,
            dests=[(d['w_final'], d['h_final']) for d in dests]))
        if saliency_postprocess.launches != before + 1:
            fail(f'{name}: dispatch_multi did not launch the kernel '
                 f'exactly once')
        for out, dest in zip(multi, dests):
            single = fullseq.run(clip, cp, fps=30.0,
                                 w_final=dest['w_final'],
                                 h_final=dest['h_final'])
            if not np.array_equal(out['boxes'], single['boxes']):
                fail(f'{name}: dispatch_multi boxes differ from run at '
                     f'{dest["w_final"]}x{dest["h_final"]}')

    # The one-shot window plan vs TransNetPredictor on the same frames.
    one = windowed.run(clip, icip, **kw)
    resize = _resize_kernel(h, w, *sal_dims(w, h, icip['max_input_d']))
    with torch.inference_mode():
        tn_frames = resize(clip)[0]
    probs = TransNetPredictor(tn)(tn_frames)
    probs_err = float(np.abs(one['probs'] - probs).max())
    if probs_err > 1e-5:
        fail(f'windowed one-shot probs differ from TransNetPredictor by '
             f'{probs_err}')

    # Small clip: the port on the card vs the port on the CPU.
    frames = small_clip()
    models = {d: small_models(d) for d in ('cuda', 'cpu')}
    box_err = {}
    for name, cp in presets.items():
        gpu, cpu = (small_clip_paths(d, models[d], frames, cp)
                    for d in ('cuda', 'cpu'))
        box_err[name] = card_vs_cpu(name, gpu, cpu)
        if gpu['two_dispatch']['n_segments'] != 2:
            fail('small clip: the stand-in did not find the cut')
    for name, (changes, t_border) in SETTINGS.items():
        cp = dict(icip, **changes)
        gpu, cpu = (small_clip_paths(d, models[d], frames, cp,
                                     all_plans=False, t_border=t_border)
                    for d in ('cuda', 'cpu'))
        box_err[name] = card_vs_cpu(name, gpu, cpu)
    focus = ism_geometry_card_vs_cpu(presets['ism'])
    emit(card, phase='exact_float32', dtype='float32', tf32=False,
         kernel_vs_plain_boxes_differing_frames=n_box_diff,
         ism_geometry_focus_card_vs_cpu=focus,
         fc_sel=fc_sel, n_segments=n_segments,
         windowed_probs_vs_predictor_max_abs=probs_err,
         multi_ratio_boxes_equal_to_run=True,
         small_clip_card_vs_cpu_max_box_px=box_err, tolerance_px=1)


def main():
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--profile', metavar='DIR', default=None,
                        help='also profile one main-path and one ISM clip '
                             'with torch.profiler and write the tables to '
                             'DIR')
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
    bench = Bench()
    program, main_outs, main_stages, launches = phase_main_path(
        card, bench, args.profile)
    record['launches'] = launches
    record['launches_by_path'] = {
        'main_path': launches,
        'windowed_plan': phase_windowed(card, bench, main_outs,
                                        main_stages),
        'multi_ratio': phase_multi_ratio(card, bench, program),
        'two_dispatch': phase_two_dispatch(card, bench),
    }
    ism_program, record['launches_by_path']['ism_main_path'] = phase_ism(
        card, bench, args.profile)
    record['launches_by_path']['ism_multi_ratio'] = phase_multi_ratio(
        card, bench, ism_program, ism_params(), 'ism_multi_ratio')
    record['launches_by_path']['ism_two_dispatch'] = phase_two_dispatch(
        card, bench, ism_params(), 'ism_two_dispatch')
    with exact_float32():
        phase_exact(card)
    if 'jax' in sys.modules:
        fail('jax was imported')
    print(json.dumps({'kernels': [record]}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
