#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Run from the root of a checkout.  It drives the port's paths -- the
one-shot clip program, raw frames to crop boxes, the two-dispatch path, the
streaming ingest with ``smart_vid_crop`` and the ``crop`` command, dynamic
(ConvGRU) saliency, UNISAL training and the sharded runners -- at full
model width and fails (exit code != 0) if any phase fails:

  (a) build: compile every CUDA kernel of the port from ``csrc/`` (one
      ``nvcc`` per source, started together) and report the seconds;
  (b) kernel vs plain version: the saliency-postprocess kernel against its
      plain PyTorch version at the main path's shape (96, 140, 250) float32
      and at further shapes (the streaming path's chunk (32, 140, 250), one
      frame, ragged, larger than a cluster holds on chip, small), on
      wide-range inputs and on an unaligned view, and at the source-
      resolution stack of ``predict_video`` (480, 360, 640) and a ragged
      (37, 360, 640), where frames overflow their cluster; all
      -inf frames give zeros, constant frames 255; the kernel must be
      bit-equal (it fails on any differing pixel and reports the count).
      Times beside the bytes bound: ``ms_device`` (cold L2) and
      ``ms_device_warm`` are device time per launch from a CUDA graph of 60
      launches replayed between two events, ``ms_call`` a single call with
      the host's enqueue in it; ``plain_ms`` is the plain version timed as
      ``ms_device``; the source stack is timed cold only (it is larger
      than the L2), over 10 launches per graph, cycling two 442 MB inputs;
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
  (j) streaming: ``crop_stream`` and ``ism_crop_stream`` feed each bench
      clip as host uint8 in 256-frame chunks through ``segment_chunks``
      (full-width float32 TransNet window plan and ``SaliencyPredictor``,
      one kernel launch per 32 picks) and ``smart_vid_crop(vid_data=...)``
      at 1:3, in turns with the one-shot window-plan program (float32 as
      well) on the same clips: per-clip times, their ratio, the registry's
      stage times, picks and launches per clip;
  (k) ``cli_crop_pickle``: the 12-shot clip written as a reference-format
      ``.pkl`` (its 11 cut indices as ``trans_inds``) through
      ``retargetvid_tpu_torch.cli.main(['crop', ..., '--save-vid'])``,
      plain and with ``--best-settings``: the boxes file, the cropped
      ``_sc.pkl`` and ``ceil(picks / 32)`` launches;
  (l) dynamic saliency: ``SaliencyPredictor.predict_video`` on the bench
      clips (full-width UNISAL with its ConvGRU, float32, ``DHF1K``,
      ``frame_modulo`` 4, ``seq_len`` 6: 80 ConvGRU chunks per clip), once
      without smoothing and once with ``med41``, in turns; per-clip times
      split by CUDA events into the chunk loop, the smoothing and the
      kernel (one launch per clip over the (480, 360, 640) stack); and on
      one clip the kernel's maps against numpy's tail of the JAX package
      (``exp``, max-normalize, uint8 in host float32) on the same
      log-probabilities: the pixels that differ, at most 1 LSB apart;
  (m) training: ``Trainer.fit`` of full-width UNISAL (default config:
      ``bn_train``, dropout live, seeded weights, float32 with TF32 as the
      card defaults) for 2 epochs of 6 DHF1K (4, 12, 224, 384) and 3
      SALICON (4, 1, 288, 384) seeded in-memory batches plus 2 + 1 valid
      batches, ``train_cnn_after=1``, ``chkpnt_warmup=0``, into a temporary
      directory: the median CUDA-event ms per train step by (source,
      frozen/trained backbone) and per eval step, frames trained per
      second, the peak of ``torch.cuda.max_memory_allocated``; it fails
      unless every loss is finite, only the trained sources' and the
      shared BatchNorm statistics moved (never the backbone's; one DHF1K
      step moves DHF1K's only), 10 steps on one batch lower its loss,
      ``save_chkpnt`` -> ``load_chkpnt`` gives identical tensors and
      ``Trainer.json`` round-trips, ``score_model`` is finite, and
      ``run_inference`` on the bench clip (DHF1K) returns (480, 360, 640)
      uint8 maps and finite scores with exactly one kernel launch, and on
      its first 81 frames as SALICON (static) three;
  (n) sharded serving (one card, so a world of 1): a 1-rank NCCL
      group, ``make_mesh`` and the three runners of ``parallel.runner``
      in turns with their single-device programs, warm-up first, a
      synchronised host clock around each run: ``ShardedOneShot`` on the
      bench clips (bf16, full-sequence plan, 480 frames padded to the
      512-frame capacity) against ``OneShotClipProgram.run``,
      ``ShardedClipRunner`` on the 12-shot clips' host structure against
      ``FusedClipProgram.run``, ``ShardedSaliency`` (``per_chip`` 16) on
      the 81 picks of a bench clip against ``SaliencyPredictor.predict``
      (frames/s); launches 1 per clip and ``ceil(81 / 16)`` per predict;
      in float32 with TF32 off, picks, shots and boxes within 1 px of the
      single-device programs and maps within 1 LSB; then two spawned
      ranks on the card over gloo (NCCL refuses two ranks on one GPU)
      run two small clips in both orders: the outputs follow the clip and
      equal the world-1 outputs, one launch per rank per batch;
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
      on the card and on the CPU, and boxes within 1 px; the windowed
      one-shot probabilities equal ``TransNetPredictor``'s within 1e-5;
      and a 96-frame 72x128 clip through ``segment_chunks`` (3 read batches
      of 40) and ``smart_vid_crop`` gives the same picks and shots on the
      card and on the CPU, boxes within 1 px, under both presets; a
      24-frame 72x128 clip through ``predict_video`` (the narrow UNISAL
      with its ConvGRU), plain and with ``med3``, gives maps within 1 LSB
      on the card and on the CPU, and ``seq_len`` 2 within 1 LSB of
      ``seq_len`` 9 on the card (the hidden state carried across chunks);
      3 train steps of the narrow UNISAL from the same weights (statistics
      drawn from a seed) and batch, every dropout mask all ones, give
      losses within 1e-4 relative and parameters and statistics within
      1e-4 in relative L2 on the card and on the CPU.

``--profile DIR`` adds one ``torch.profiler`` run of a clip on each of
the main path, the ISM main path, the two streaming phases and
``predict_video``, and of one DHF1K and one SALICON train step (device busy
time, idle share, kernel launches, the postprocess kernel's own device
time; the per-operator tables go to ``DIR/profile_<phase>.txt``).

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
#: The streaming path's postprocess input: one ``SaliencyPredictor`` chunk.
CHUNK_SHAPE = (32, 140, 250)
#: Further shapes the kernel is held at: the chunk; one frame; a ragged
#: frame (hw % 4 != 0); frames larger than a cluster holds on chip; small
#: frames.
EXTRA_SHAPES = (CHUNK_SHAPE, (1, 140, 250), (3, 37, 53), (2, 720, 1280),
                (5, 32, 128))
#: ``predict_video``'s postprocess input on the bench clip: every frame at
#: the source resolution, larger than a cluster of 8 holds on chip; and a
#: clip of 37 frames.
SOURCE_SHAPE = (480, 360, 640)
RAGGED_SOURCE_SHAPE = (37, 360, 640)
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
    bound_ms, bound_by, moved = kernel_bound(MAIN_SHAPE)
    t, h, w = MAIN_SHAPE
    plan = launch_plan(t, h * w)

    # The streaming path's chunk: 16 inputs of 4.48 MB (71.7 MB) cycle
    # through the L2.
    chunk_cold = [log_maps(CHUNK_SHAPE, seed=20 + i)[0] for i in range(16)]
    chunk_bound, chunk_by, _ = kernel_bound(CHUNK_SHAPE)
    chunk = {'shape': list(CHUNK_SHAPE),
             'plan': launch_plan(CHUNK_SHAPE[0],
                                 CHUNK_SHAPE[1] * CHUNK_SHAPE[2])._asdict(),
             'ms_device': device_ms(saliency_postprocess, chunk_cold),
             'ms_device_warm': device_ms(saliency_postprocess,
                                         chunk_cold[:1]),
             'plain_ms': device_ms(saliency_postprocess_reference,
                                   chunk_cold),
             'bound_ms': chunk_bound, 'bound_by': chunk_by}
    chunk['bound_share'] = chunk_bound / chunk['ms_device']
    del chunk_cold
    source = source_stack_record(cases)
    max_err = max(c['max_abs_err'] for c in cases)
    emit(card, phase='kernel', kernel='saliency_postprocess',
         shape=list(MAIN_SHAPE), plan=plan._asdict(), cases=cases,
         max_abs_err=max_err, tolerance='0 LSB', ms_device=ms_dev,
         ms_device_warm=ms_dev_warm, ms_call=ms_call, plain_ms=plain_ms,
         plain_ms_call=plain_ms_call, same_bytes_cast_ms=cast_ms,
         bound_ms=bound_ms, bound_by=bound_by,
         bound_share=bound_ms / ms_dev, bytes=moved, chunk=chunk,
         source_stack=source)
    return {'name': 'saliency_postprocess', 'route': 'cuda',
            'source': 'retargetvid_tpu_torch/csrc/saliency_postprocess.cu',
            'replaces': 'retargetvid_tpu/ops/pallas_kernels.py:39',
            'cluster': plan.cluster,
            'max_abs_err': max_err, 'ms': ms_dev, 'ms_device': ms_dev,
            'ms_device_warm': ms_dev_warm, 'ms_call': ms_call,
            'plain_ms': plain_ms, 'bound_ms': bound_ms, 'bound_by': bound_by,
            # No single PyTorch call computes exp + per-frame max-normalize
            # + uint8 quantization.
            'library_ms': None, 'chunk': chunk, 'source_stack': source}


def source_stack_record(cases):
    """The kernel at ``predict_video``'s source-resolution stacks: bit-equal
    to the plain version at :data:`SOURCE_SHAPE` and
    :data:`RAGGED_SOURCE_SHAPE` (the cases are appended to ``cases``), and
    timed at the first beside its bytes bound.  Two 442 MB inputs cycle,
    10 launches per graph."""
    import torch

    from retargetvid_tpu_torch.kernels.postprocess import (
        launch_plan,
        saliency_postprocess,
        saliency_postprocess_reference,
    )
    for i, shape in enumerate((SOURCE_SHAPE, RAGGED_SOURCE_SHAPE)):
        x, sp = log_maps(shape, seed=40 + i)
        cases.append(check_kernel_case(x, sp, 'x'.join(map(str, shape))))
        del x
    cold = [log_maps(SOURCE_SHAPE, seed=50 + i)[0] for i in range(2)]
    bound, by, moved = kernel_bound(SOURCE_SHAPE)
    t, h, w = SOURCE_SHAPE
    rec = {'shape': list(SOURCE_SHAPE),
           'plan': launch_plan(t, h * w)._asdict(),
           'ms_device': device_ms(saliency_postprocess, cold, n=10, reps=7),
           'ms_device_warm': 'not measured: one 442 MB input is about 9x '
                             'the 50 MB L2, so no launch finds it warm',
           'ms_call': call_ms(lambda: saliency_postprocess(cold[0]), n=10),
           'plain_ms': device_ms(saliency_postprocess_reference, cold, n=10,
                                 reps=7),
           'bound_ms': bound, 'bound_by': by, 'bytes': moved}
    rec['bound_share'] = bound / rec['ms_device']
    del cold
    torch.cuda.empty_cache()
    return rec


def kernel_bound(shape):
    """The postprocess's least time on an H100 at ``shape``: (ms, what
    bounds it, bytes moved)."""
    n_px = int(np.prod(shape))
    moved = n_px * 4 + n_px * 1                   # read f32, write uint8
    ops = n_px * 4                                # exp, max, divide, scale
    by_bytes, by_ops = moved / H100_BYTES_PER_S, ops / H100_FP32_FLOPS
    return (max(by_bytes, by_ops) * 1e3,
            'bytes' if by_bytes >= by_ops else 'operations', moved)


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
        profile_clip(card, lambda: program.run(bench.clips[0], bench.cp,
                                               **bench.kw),
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
        profile_clip(card, lambda: program.run(bench.clips[0], cp,
                                               **bench.kw),
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


def stream_chunks(frames, size=256):
    """``(chunk, start)`` pairs of ``frames``, as the decoder hands them."""
    return ((frames[s:s + size], s) for s in range(0, len(frames), size))


def stream_crop(frames, cp, transnet_fn, saliency_fn, device=None,
                fps=30.0):
    """One clip through the streaming ingest (``segment_chunks``) and
    ``smart_vid_crop(vid_data=...)``; returns (vid_data, results, stage
    seconds of the timing registry)."""
    from retargetvid_tpu_torch.pipeline.crop import smart_vid_crop
    from retargetvid_tpu_torch.pipeline.ingest import segment_chunks
    from retargetvid_tpu_torch.utils.timing import sc_init_time, sc_times
    n, h, w = frames.shape[:3]
    info = {'fps': fps, 'frame_count': n, 'width': w, 'height': h}
    sc_init_time()
    vd = segment_chunks(info, stream_chunks(frames), cp, transnet_fn,
                        saliency_fn, device=device)
    ingest = sc_times()
    vd, res = smart_vid_crop('clip', cp, save_vid=False, vid_data=vd,
                             device=device)
    return vd, res, {**ingest, **sc_times()}


def expect_chunk_launches(path, launches, picks, chunk=32):
    want = -(-picks // chunk)
    if launches != want:
        fail(f'{path}: {launches} saliency_postprocess launches for {picks} '
             f'picks (expected {want}, one per chunk of {chunk})')


def phase_crop_stream(card, bench, cp=None, phase='crop_stream',
                      profile_dir=None):
    """The streaming path on the bench clips (host uint8 frames in
    256-frame chunks), in turns with the one-shot window-plan program on
    the same clips; ``cp`` defaults to the bench's ICIP parameters.
    Returns the streaming path's kernel launches."""
    import torch

    from retargetvid_tpu_torch.kernels.postprocess import saliency_postprocess
    from retargetvid_tpu_torch.models.transnet import TransNetPredictor
    from retargetvid_tpu_torch.pipeline.oneshot import (
        OneShotClipProgram,
        StageTimer,
    )
    from retargetvid_tpu_torch.pipeline.saliency import SaliencyPredictor
    cp = cp or bench.cp
    # Both sides in float32, the CLI's precision, so that the ratio holds
    # only what streaming adds: the upload, the stitched batches and the
    # host round trip of the maps.
    tn32 = build_models()[0]
    transnet_fn = TransNetPredictor(tn32)                # windows
    saliency_fn = SaliencyPredictor(bench.un).predict    # chunk 32
    program = OneShotClipProgram(tn32, bench.un, dtype=torch.float32)
    host = [c.cpu().numpy() for c in bench.clips]

    def stream(frames):
        return stream_crop(frames, cp, transnet_fn, saliency_fn)

    def oneshot(clip):
        return program.run(clip, cp, **bench.kw)

    stream(bench.warm.cpu().numpy())
    oneshot(bench.warm)
    program.timer = StageTimer()
    ms = {'stream': [], 'oneshot': []}
    launches = {'stream': [], 'oneshot': []}
    stages, picks, series = [], [], []
    for i, (clip, frames) in enumerate(zip(bench.clips, host)):
        order = ('stream', 'oneshot') if i % 2 == 0 else ('oneshot',
                                                          'stream')
        for name in order:
            torch.cuda.synchronize()
            saliency_postprocess.launches = 0
            t0 = time.perf_counter()
            if name == 'stream':
                vd, res, times = stream(frames)
            else:
                oneshot(clip)
            ms[name].append((time.perf_counter() - t0) * 1e3)
            launches[name].append(saliency_postprocess.launches)
        check_boxes(np.asarray(vd['bbs']), bench.dest, bench.h, bench.w)
        if res['result'] != 'smart cropped':
            fail(f'{phase}: result {res["result"]!r}')
        picks.append(vd['fc_sel'])
        series.append({'jumps': np.asarray(vd['jumps']),
                       'fc_sel': vd['fc_sel']})
        stages.append(times)
        expect_chunk_launches(phase, launches['stream'][-1], vd['fc_sel'])
    expect_launches(f'{phase}, one-shot windowed', sum(launches['oneshot']),
                    len(bench.clips))
    one_stages = {k: statistics.median(v)
                  for k, v in program.timer.times_ms().items()}
    med = statistics.median(ms['stream'])
    one_med = statistics.median(ms['oneshot'])
    extra = focus_stats(series, cp, bench.fps) if cp['focus_stability'] \
        else {}
    emit(card, phase=phase, clip=[480, bench.h, bench.w], dtype='float32',
         tn_plan='windowed', chunk_frames=256, read_batch=cp['read_batch'],
         per_clip_ms=ms['stream'], median_ms=med,
         spread_ms=[min(ms['stream']), max(ms['stream'])],
         frames_per_s=480 / med * 1e3,
         stage_median_ms={k: statistics.median(t[k] for t in stages) * 1e3
                          for k in stages[0]},
         fc_sel=picks, **extra, launches_per_clip=launches['stream'],
         boxes_in_frame_at_dest=True,
         oneshot_windowed_f32_per_clip_ms=ms['oneshot'],
         oneshot_windowed_median_ms=one_med,
         oneshot_stage_median_ms=one_stages,
         stream_over_oneshot=med / one_med)
    if profile_dir is not None:
        profile_clip(card, lambda: stream(host[0]), Path(profile_dir), phase)
    return sum(launches['stream'])


def phase_cli_crop_pickle(card, bench):
    """``cli crop`` on the 12-shot clip written as a reference ``.pkl``,
    plain and with ``--best-settings``; returns the kernel launches."""
    import pickle
    import tempfile

    from retargetvid_tpu_torch import cli
    from retargetvid_tpu_torch.eval.annotations import read_boxes_file
    from retargetvid_tpu_torch.kernels.postprocess import saliency_postprocess
    from retargetvid_tpu_torch.pipeline.ingest import sample_frames
    frames = make_clip(seed=0, shot_len=40)
    fc = len(frames)
    trans_inds = list(range(39, fc - 1, 40))            # 11 cuts
    probs = np.zeros(fc, np.float32)
    probs[trans_inds] = 1.0
    picks = len(sample_frames(fc, probs, bench.cp['skip'], fc)[1])
    runs = {}
    total = 0
    with tempfile.TemporaryDirectory() as tmp:
        pkl = Path(tmp) / 'clip.pkl'
        with open(pkl, 'wb') as fp:
            pickle.dump({'fr': bench.fps, 'frame_count': fc, 'w': bench.w,
                         'h': bench.h, 'frames': frames,
                         'trans_inds': trans_inds}, fp)
        for preset, extra in (('icip', []), ('ism', ['--best-settings'])):
            out = Path(tmp) / f'out_{preset}'
            saliency_postprocess.launches = 0
            t0 = time.perf_counter()
            cli.main(['crop', str(pkl), '--ratio', '1:3', '--save-vid',
                      '--out', str(out)] + extra)
            wall = time.perf_counter() - t0
            launches = saliency_postprocess.launches
            total += launches
            expect_chunk_launches(f'cli_crop_pickle {preset}', launches,
                                  picks)
            boxes = read_boxes_file(f'{out}.txt')
            check_boxes(boxes, bench.dest, bench.h, bench.w)
            with open(Path(tmp) / 'clip_sc.pkl', 'rb') as fp:
                cropped = pickle.load(fp)
            want = np.stack([f[y1:y2, x1:x2]
                             for f, (x1, y1, x2, y2) in zip(frames, boxes)])
            if not np.array_equal(cropped['frames'], want):
                fail(f'cli_crop_pickle {preset}: clip_sc.pkl does not hold '
                     f'the frames cropped by the boxes')
            runs[preset] = {'wall_s': wall, 'launches': launches,
                            'sc_frames': list(cropped['frames'].shape)}
    emit(card, phase='cli_crop_pickle', clip=[fc, bench.h, bench.w],
         shots=len(trans_inds) + 1, picks=picks, runs=runs,
         boxes_in_frame_at_dest=True)
    return total


def numpy_tail(logp: np.ndarray) -> np.ndarray:
    """The JAX package's ``predict_video`` tail
    (``retargetvid_tpu/pipeline/saliency.py:180-183``), host float32."""
    p = np.exp(logp)
    mx = p.max(axis=(1, 2), keepdims=True)
    p = np.where(mx > 0, p / mx, p) * 255.0
    return p.astype(np.uint8)


def tail_vs_numpy(predictor, clip, smooth):
    """``predict_video`` on ``clip`` with the kernel's input captured: the
    kernel's maps against :func:`numpy_tail` of the same log-probabilities
    fetched to the host.  Returns (differing pixels, max LSB)."""
    from retargetvid_tpu_torch.pipeline import saliency
    real = saliency.saliency_postprocess
    seen = {}

    def capture(logp):
        seen['logp'] = logp
        return real(logp)

    saliency.saliency_postprocess = capture
    try:
        maps = predictor.predict_video(clip, smooth_method=smooth)
    finally:
        saliency.saliency_postprocess = real
    ref = numpy_tail(seen.pop('logp').cpu().numpy())
    diff = np.abs(maps.astype(np.int16) - ref.astype(np.int16))
    return int((diff > 0).sum()), int(diff.max())


def phase_predict_video(card, bench, profile_dir=None):
    """Dynamic saliency on the bench clips, without smoothing and with
    ``med41`` in turns; returns the kernel's launches of each."""
    import torch

    from retargetvid_tpu_torch.kernels.postprocess import saliency_postprocess
    from retargetvid_tpu_torch.pipeline.oneshot import StageTimer
    from retargetvid_tpu_torch.pipeline.saliency import SaliencyPredictor
    predictor = SaliencyPredictor(bench.un)            # float32
    chunks = [0]
    hook = bench.un.rnn.register_forward_hook(
        lambda *_: chunks.__setitem__(0, chunks[0] + 1))
    modes = {'none': None, 'med41': 'med41'}
    n_frames = int(bench.warm.shape[0])
    try:
        for smooth in modes.values():
            predictor.predict_video(bench.warm, smooth_method=smooth)
        ms = {m: [] for m in modes}
        launches = {m: [] for m in modes}
        n_chunks = {m: [] for m in modes}
        stages = {m: [] for m in modes}
        for i, clip in enumerate(bench.clips):
            order = list(modes) if i % 2 == 0 else list(modes)[::-1]
            for mode in order:
                predictor.timer = StageTimer()
                torch.cuda.synchronize()
                saliency_postprocess.launches = 0
                chunks[0] = 0
                t0 = time.perf_counter()
                maps = predictor.predict_video(clip,
                                               smooth_method=modes[mode])
                ms[mode].append((time.perf_counter() - t0) * 1e3)
                launches[mode].append(saliency_postprocess.launches)
                n_chunks[mode].append(chunks[0])
                stages[mode].append({k: v[0] for k, v in
                                     predictor.timer.times_ms().items()})
                if maps.shape != (n_frames, bench.h, bench.w) or not (
                        maps.reshape(n_frames, -1).max(axis=1) == 255).all():
                    fail(f'predict_video {mode}: maps of shape {maps.shape} '
                         f'or a frame whose maximum is not 255')
        predictor.timer = None
        tails = {m: tail_vs_numpy(predictor, bench.clips[0], modes[m])
                 for m in modes}
    finally:
        hook.remove()
    want_chunks = sum(-(-len(range(o, n_frames, 4)) // 6) for o in range(4))
    for mode in modes:
        if launches[mode] != [1] * len(bench.clips):
            fail(f'predict_video {mode}: {launches[mode]} kernel launches '
                 f'per clip (expected 1)')
        if n_chunks[mode] != [want_chunks] * len(bench.clips):
            fail(f'predict_video {mode}: {n_chunks[mode]} ConvGRU chunks '
                 f'per clip (expected {want_chunks})')
        if tails[mode][1] > 1:
            fail(f'predict_video {mode}: the kernel differs from numpy\'s '
                 f'tail by {tails[mode][1]} LSB')
    for mode in modes:
        med = statistics.median(ms[mode])
        emit(card, phase='predict_video' if mode == 'none'
             else f'predict_video_{mode}',
             clip=[n_frames, bench.h, bench.w], dtype='float32',
             source='DHF1K', frame_modulo=4, seq_len=6,
             smooth=modes[mode], per_clip_ms=ms[mode], median_ms=med,
             frames_per_s=n_frames / med * 1e3,
             stage_median_ms={k: statistics.median(s[k] for s in
                                                   stages[mode])
                              for k in stages[mode][0]},
             launches_per_clip=launches[mode],
             convgru_chunks_per_clip=n_chunks[mode],
             kernel_vs_numpy_tail={'differing_px': tails[mode][0],
                                   'of_px': n_frames * bench.h * bench.w,
                                   'max_lsb': tails[mode][1]})
    if profile_dir is not None:
        profile_clip(card, lambda: predictor.predict_video(bench.clips[0]),
                     Path(profile_dir), 'predict_video')
    return sum(launches['none']), sum(launches['med41'])


#: ``cli train``'s default batch size with the datasets' default clip and
#: grid: DHF1K (B, T, H, W) = (4, 12, 224, 384), SALICON (4, 1, 288, 384).
TRAIN_SHAPES = {'DHF1K': (4, 12, 224, 384), 'SALICON': (4, 1, 288, 384)}


class MemLoader:
    """Zero-arg batch-iterator factory over batches held on the card."""

    def __init__(self, batches):
        self.batches = batches
        self.n_batches = len(batches)

    def __call__(self):
        return iter(self.batches)


def train_batches(source, n, seed):
    """``n`` seeded numpy batches of ``source``'s shape, moved to the card:
    normal frames, saliency normalized to a distribution per frame, 0.5%
    of pixels fixated."""
    import torch
    b, t, h, w = TRAIN_SHAPES[source]
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = rng.standard_normal((b, t, h, w, 3), dtype=np.float32)
        sal = rng.random((b, t, h, w, 1), dtype=np.float32) ** 4
        sal /= sal.sum(axis=(2, 3, 4), keepdims=True)
        fix = (rng.random((b, t, h, w, 1), dtype=np.float32)
               > 0.995).astype(np.float32)
        out.append(tuple(torch.from_numpy(a).cuda() for a in (x, sal, fix)))
    return out


def bn_stats(model):
    return {n: b.detach().clone() for n, b in model.named_buffers()
            if n.endswith(('running_mean', 'running_var'))}


def moved_stats(before, model):
    import torch
    now = bn_stats(model)
    return sorted(n for n in before if not torch.equal(before[n], now[n]))


class StepTimes:
    """CUDA-event times and peak allocated bytes of wrapped calls, by
    key."""

    def __init__(self):
        self.ms = {}
        self.peak = {}

    def wrap(self, key, fn):
        import torch

        def timed(*args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.reset_peak_memory_stats()
            start.record()
            out = fn(*args)
            end.record()
            end.synchronize()
            self.ms.setdefault(key, []).append(start.elapsed_time(end))
            self.peak[key] = max(self.peak.get(key, 0),
                                 torch.cuda.max_memory_allocated())
            return out

        return timed


def batch_stat_loss(model, x, sal, fix):
    """The DHF1K loss of one forward with the batch's statistics and no
    dropout; the running statistics are left as they were."""
    import torch

    from retargetvid_tpu_torch.train.losses import loss_sequences
    saved = bn_stats(model)
    with torch.no_grad():
        logp = model(x, source='DHF1K', static=False)
        kld, nss, cc = (torch.mean(v) for v in
                        loss_sequences(logp, sal, fix))
    buffers = dict(model.named_buffers())
    for n, v in saved.items():
        buffers[n].copy_(v)
    return float(kld - 0.1 * nss - 0.1 * cc)


def check_stats_moved(moved, active, label):
    """Only ``active`` sources' and the shared BatchNorms' statistics
    moved, the backbone's did not, and the active ones did."""
    others = [s for s in ('dhf1k', 'hollywood', 'ucfsports', 'salicon')
              if s not in active]
    bad = [n for n in moved if n.startswith('cnn.')
           or any(f'bn_{s}.' in n for s in others)]
    if bad:
        fail(f'{label}: statistics moved that must not: {bad[:4]}')
    for s in active:
        if not any(f'bn_{s}.' in n for n in moved):
            fail(f'{label}: no {s} statistic moved')
    if not any(n.startswith('post_cnn.') for n in moved):
        fail(f'{label}: the shared post_cnn statistics did not move')


def inference_targets(frames):
    """Saliency (the frames' brightness) and 6 fixations per frame (the
    brightest pixel and 5 seeded ones) of a (T, H, W, 3) card clip, host
    numpy."""
    gray = frames.float().mean(-1)
    t, h, w = gray.shape
    fix = np.zeros((t, h, w), np.float32)
    top = gray.reshape(t, -1).argmax(1).cpu().numpy()
    fix.reshape(t, -1)[np.arange(t), top] = 1.0
    rng = np.random.default_rng(11)
    fix[np.repeat(np.arange(t), 5), rng.integers(0, h, 5 * t),
        rng.integers(0, w, 5 * t)] = 1.0
    return gray.cpu().numpy(), fix


def phase_train(card, bench, profile_dir=None):
    """UNISAL training at full width (see the module docstring, (m));
    returns the kernel's launches of ``run_inference`` on a dynamic and
    on a static source."""
    import tempfile

    import torch

    from retargetvid_tpu_torch.kernels.postprocess import saliency_postprocess
    from retargetvid_tpu_torch.train import trainer as trainer_mod
    from retargetvid_tpu_torch.train.trainer import Trainer
    loaders = {
        'DHF1K': {'train': MemLoader(train_batches('DHF1K', 6, 0)),
                  'valid': MemLoader(train_batches('DHF1K', 2, 1))},
        'SALICON': {'train': MemLoader(train_batches('SALICON', 3, 2)),
                    'valid': MemLoader(train_batches('SALICON', 1, 3))},
    }
    tr = Trainer(num_epochs=2, train_cnn_after=1, steps_per_epoch=9)
    tr.init_state(rng_seed=0)
    before = bn_stats(tr.model)
    times = StepTimes()
    step_fn, make_eval = tr.step_fn, trainer_mod.make_eval_step
    tr.step_fn = lambda src, static, cnn: times.wrap(
        (src, 'train_cnn' if cnn else 'frozen_cnn'), step_fn(src, static,
                                                             cnn))
    trainer_mod.make_eval_step = lambda model, **kw: times.wrap(
        (kw['source'], 'eval'), make_eval(model, **kw))
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        try:
            best = tr.fit(loaders, tmp, chkpnt_warmup=0)
        finally:
            tr.step_fn = step_fn
            trainer_mod.make_eval_step = make_eval
        fit_s = time.perf_counter() - t0
        files = sorted(p.name for p in Path(tmp).iterdir())
        losses = [v for epoch in tr.history for v in epoch.values()]
        if not np.isfinite(losses).all():
            fail(f'train: a loss is not finite: {tr.history}')
        check_stats_moved(moved_stats(before, tr.model),
                          ('dhf1k', 'salicon'), 'train fit')
        # Checkpoint round trip through Trainer.json.
        path = tr.save_chkpnt(tmp, 99)
        back = Trainer.init_from_cfg_dir(tmp)
        back.load_chkpnt(path)
        if back.asdict() != tr.asdict():
            fail('train: Trainer.json does not round-trip')
        sd, sd2 = tr.model.state_dict(), back.model.state_dict()
        same = all(torch.equal(sd[k], sd2[k]) for k in sd) and all(
            torch.equal(v, back.state.opt_state['trace'][n])
            for n, v in tr.state.opt_state['trace'].items()) and (
            back.state.step, back.state.opt_state['count']) == (
            tr.state.step, tr.state.opt_state['count'])
        if not same:
            fail('train: save_chkpnt -> load_chkpnt changed a tensor')
        del back
    scores = tr.score_model(loaders['DHF1K']['valid'](), source='DHF1K')
    if not all(np.isfinite(v) for v in scores.values()):
        fail(f'train: score_model gave {scores}')

    # One source's step: its statistics move, no other source's, never the
    # backbone's; 10 steps on one fixed batch lower its loss (a forward
    # with the batch's statistics and no dropout: the running statistics
    # have moved only 10% of the way at momentum 0.99).
    ov = Trainer(steps_per_epoch=10)
    ov.init_state(rng_seed=5)
    batch = loaders['DHF1K']['train'].batches[0]
    loss0 = batch_stat_loss(ov.model, *batch)
    before = bn_stats(ov.model)
    step = ov.step_fn('DHF1K', False, True)
    for i in range(10):
        ov.state, _ = step(ov.state, *batch)
        if i == 0:
            check_stats_moved(moved_stats(before, ov.model), ('dhf1k',),
                              'one DHF1K step')
    loss10 = batch_stat_loss(ov.model, *batch)
    if not loss10 < loss0:
        fail(f'train: 10 steps on one batch did not lower its loss '
             f'({loss0} -> {loss10})')
    if profile_dir is not None:
        for src in ('DHF1K', 'SALICON'):
            batch = loaders[src]['train'].batches[0]
            prof_step = ov.step_fn(src, src == 'SALICON', True)

            def one():
                ov.state, _ = prof_step(ov.state, *batch)
            one()
            profile_clip(card, one, Path(profile_dir),
                         f'train_step_{src.lower()}')
    del ov

    # run_inference: the bench clip through the dynamic path (one kernel
    # launch), its first 81 frames through the static one (3); timed for
    # the maps alone, then with the host's numpy scoring.
    clip = bench.clips[0]
    sal, fix = inference_targets(clip)
    launches, ms = {}, {}
    for label, source, frames in (('dynamic', 'DHF1K', clip),
                                  ('static', 'SALICON', clip[:81])):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.run_inference(frames, source=source)
        ms[f'{label}_maps'] = (time.perf_counter() - t0) * 1e3
        saliency_postprocess.launches = 0
        t0 = time.perf_counter()
        maps, inf_scores = tr.run_inference(frames, source=source,
                                            sal=sal[:len(frames)],
                                            fix=fix[:len(frames)])
        ms[f'{label}_maps_and_scores'] = (time.perf_counter() - t0) * 1e3
        launches[label] = saliency_postprocess.launches
        want = 1 if label == 'dynamic' else -(-len(frames) // 32)
        if launches[label] != want:
            fail(f'train run_inference {label}: {launches[label]} kernel '
                 f'launches (expected {want})')
        if maps.shape != tuple(frames.shape[:3]) or maps.dtype != np.uint8:
            fail(f'train run_inference {label}: maps {maps.shape} '
                 f'{maps.dtype}')
        if set(inf_scores) != {'kld', 'nss', 'cc', 'sim', 'aucj'} or not \
                all(np.isfinite(v) for v in inf_scores.values()):
            fail(f'train run_inference {label}: scores {inf_scores}')
        scores[f'run_inference_{label}'] = inf_scores

    def med(key):
        return statistics.median(times.ms[key]) if key in times.ms else None

    train_keys = [k for k in times.ms if k[1] != 'eval']
    n_frames = sum(len(times.ms[k]) * TRAIN_SHAPES[k[0]][0]
                   * TRAIN_SHAPES[k[0]][1] for k in train_keys)
    step_ms = sum(sum(times.ms[k]) for k in train_keys)
    median_step_ms = sum(med(k) * len(times.ms[k]) for k in train_keys)
    emit(card, phase='train', model='UNISAL full width (MobileNetV2 1.0, '
         'ConvGRU 256, 41-tap smoothing), bn_train, drop_probs '
         '(0.0, 0.6, 0.6), float32 (TF32 as the card defaults)',
         shapes={k: list(v) for k, v in TRAIN_SHAPES.items()},
         epochs=2, train_batches={'DHF1K': 6, 'SALICON': 3},
         valid_batches={'DHF1K': 2, 'SALICON': 1}, train_cnn_after=1,
         step_median_ms={f'{k[0]}/{k[1]}': med(k) for k in times.ms},
         step_first_ms={f'{k[0]}/{k[1]}': v[0] for k, v in times.ms.items()},
         step_count={f'{k[0]}/{k[1]}': len(v) for k, v in times.ms.items()},
         train_frames_per_s=n_frames / step_ms * 1e3,
         train_frames_per_s_at_median_steps=n_frames / median_step_ms * 1e3,
         fit_s=fit_s,
         max_memory_allocated_bytes={f'{k[0]}/{k[1]}': v
                                     for k, v in times.peak.items()},
         best_val_score=best,
         files=files, overfit_batch_stat_loss=[loss0, loss10],
         scores=scores,
         run_inference_ms=ms, run_inference_launches=launches)
    return launches['dynamic'], launches['static']


def draw_stats(model, seed):
    """BatchNorm running statistics drawn from ``seed`` (means N(0, 0.2),
    variances U(0.5, 1.5)).  With the init's zero means and biases, exact
    zeros run through the backbone and leave whole channels of the
    decoder's train-mode BatchNorm with zero variance, where rounding
    times 1/sqrt(eps) decides ReLU6 gates: a comparison of two devices
    would measure that, not the port."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith('running_mean'):
                buf.copy_(0.2 * torch.randn(buf.shape, generator=gen))
            elif name.endswith('running_var'):
                buf.copy_(0.5 + torch.rand(buf.shape, generator=gen))


def train_card_vs_cpu():
    """3 train steps of the narrow UNISAL (float32, TF32 off, every dropout
    mask all ones, statistics drawn from a seed) from the same weights and
    DHF1K batch on the card and on the CPU: losses within 1e-4 relative,
    parameters and statistics within 1e-4 in relative L2 (chained steps
    move single entries by more: see ``tests/test_torch_trainer.py``).
    Returns the differences."""
    import torch

    from retargetvid_tpu_torch.convert import state_dict_to_flax
    from retargetvid_tpu_torch.models import dropout
    from retargetvid_tpu_torch.train.trainer import Trainer
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 3, 64, 64, 3), dtype=np.float32)
    sal = rng.random((2, 3, 64, 64, 1), dtype=np.float32) ** 2
    sal /= sal.sum(axis=(2, 3, 4), keepdims=True)
    fix = (rng.random((2, 3, 64, 64, 1)) > 0.98).astype(np.float32)
    real = dropout.keep_mask
    dropout.keep_mask = lambda shape, keep, gen: torch.ones(
        tuple(shape), dtype=torch.bool, device=gen.device)
    try:
        trainers = {d: Trainer(model_cfg=TINY_UNISAL, device=d,
                               steps_per_epoch=2)
                    for d in ('cuda', 'cpu')}
        trainers['cpu'].init_state(rng_seed=3)
        draw_stats(trainers['cpu'].model, 3)
        trainers['cuda'].init_state(
            variables=state_dict_to_flax(trainers['cpu'].model))
        losses = {}
        for d, tr in trainers.items():
            step = tr.step_fn('DHF1K', False, True)
            losses[d] = []
            for _ in range(3):
                tr.state, out = step(tr.state, *(tr._batch(a)
                                                 for a in (x, sal, fix)))
                losses[d].append(float(out['loss']))
    finally:
        dropout.keep_mask = real
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses['cuda'],
                                                      losses['cpu']))
    card = trainers['cuda'].model.state_dict()
    host = {k: v.float() for k, v in trainers['cpu'].model.state_dict().items()
            if v.is_floating_point()}
    diff = {k: card[k].cpu().float() - v for k, v in host.items()}
    state_err = float(torch.sqrt(sum((d * d).sum() for d in diff.values()))
                      / torch.sqrt(sum((v * v).sum() for v in host.values())))
    worst = max(diff, key=lambda k: float(diff[k].abs().max()))
    if loss_err > 1e-4 or state_err > 1e-4:
        fail(f'train card vs CPU: losses {losses}, parameters and '
             f'statistics {state_err} apart (relative L2)')
    return {'losses': losses, 'loss_max_rel_diff': loss_err,
            'state_rel_l2_diff': state_err, 'tolerance': 1e-4,
            'state_max_abs_diff': float(diff[worst].abs().max()),
            'state_max_abs_diff_at': worst}


def clip_structure(clip, cp, resize, profile):
    """A raw clip as ``read_video_structure`` gives it: the saliency frames
    (on the device), the host picks and scene tables of ``profile``'s
    probabilities."""
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
        tn_frames, sal = resize(clip)
    probs = profile(tn_frames)
    selected, true_inds, m2o = sample_frames(fc, probs, cp['skip'], fc)
    seg = fix_scene_bounds(predictions_to_scenes(probs, TRANS_THRESHOLD), fc)
    return {'sal_frames': sal, 'selected': selected, 'true_inds': true_inds,
            'segmentation': seg,
            'segmentation_sel': scenes_to_selected(seg, m2o), 'fc': fc}


def in_turns(runs, clips):
    """Each of ``runs`` (name -> fn(clip)) on each clip, the order flipped
    every clip, a synchronised host clock around each; the kernel's launches
    of each run counted from 0.  Returns per-run ms lists, outputs and
    launch totals."""
    import torch

    from retargetvid_tpu_torch.kernels.postprocess import saliency_postprocess
    names = list(runs)
    ms = {n: [] for n in names}
    outs = {n: [] for n in names}
    launches = dict.fromkeys(names, 0)
    for i, clip in enumerate(clips):
        for name in (names if i % 2 == 0 else names[::-1]):
            torch.cuda.synchronize()
            saliency_postprocess.launches = 0
            t0 = time.perf_counter()
            outs[name].append(runs[name](clip))
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t0) * 1e3)
            launches[name] += saliency_postprocess.launches
    return ms, outs, launches


def max_abs_diff(a, b):
    return int(np.abs(np.asarray(a, np.int64) - np.asarray(b, np.int64)).max())


def sharded_exact(mesh, bench, clip12, sal_frames):
    """Under float32 with TF32 off, each sharded runner on a world of 1
    against its single-device program: picks, shots and boxes within 1 px,
    maps within 1 LSB."""
    import torch

    from retargetvid_tpu_torch.parallel.runner import (
        ShardedClipRunner,
        ShardedOneShot,
        ShardedSaliency,
    )
    from retargetvid_tpu_torch.pipeline.fused import FusedClipProgram
    from retargetvid_tpu_torch.pipeline.oneshot import OneShotClipProgram
    from retargetvid_tpu_torch.pipeline.saliency import SaliencyPredictor
    tn, un = build_models()
    clip = bench.clips[0]
    kw = dict(bench.kw, h_orig=bench.h, w_orig=bench.w)
    with exact_float32():
        sh = ShardedOneShot(mesh, tn, un, dtype=torch.float32,
                            tn_fullseq=True).run_batch([clip], bench.cp,
                                                       **bench.kw)[0]
        one = OneShotClipProgram(tn, un, dtype=torch.float32,
                                 tn_fullseq=True).run(clip, bench.cp,
                                                      **bench.kw)
        runner = ShardedClipRunner(mesh, un).run_batch([clip12], bench.cp,
                                                       **kw)[0]
        fused = FusedClipProgram(un, dtype=torch.float32).run(
            clip12['sal_frames'], clip12['selected'], clip12['true_inds'],
            clip12['segmentation'], clip12['segmentation_sel'], bench.cp,
            fc=clip12['fc'], **kw)
        maps = ShardedSaliency(mesh, un).predict(sal_frames)
        ref_maps = SaliencyPredictor(un).predict(sal_frames)
    rec = {
        'oneshot': {'fc_sel': [sh['fc_sel'], one['fc_sel']],
                    'n_segments': [sh['n_segments'], one['n_segments']],
                    'max_box_px': max_abs_diff(sh['boxes'], one['boxes']),
                    'probs_max_abs': float(np.abs(sh['probs'][:480]
                                                  - one['probs'][:480]).max())},
        'clip_runner': {'max_box_px': max_abs_diff(runner['boxes'],
                                                 fused['boxes'])},
    }
    diff = np.abs(maps.astype(int) - ref_maps.astype(int))
    rec['saliency'] = {'max_lsb': int(diff.max()),
                       'n_differing': int((diff > 0).sum()),
                       'n_px': int(diff.size)}
    if (sh['fc_sel'], sh['n_segments']) != (one['fc_sel'],
                                            one['n_segments']):
        fail('sharded: ShardedOneShot picks or shots differ from '
             'OneShotClipProgram in float32')
    if rec['oneshot']['max_box_px'] > 1 or \
            rec['clip_runner']['max_box_px'] > 1:
        fail(f'sharded: boxes differ from the single-device programs by '
             f'more than 1 px: {rec}')
    if rec['saliency']['max_lsb'] > 1:
        fail(f'sharded: ShardedSaliency maps differ by more than 1 LSB: '
             f'{rec["saliency"]}')
    return rec


def two_rank_main(rank, store, out_path, clips, cp, kw):
    """One of two ranks on the one card over gloo: the small clips through
    ``ShardedOneShot`` in both orders, float32 with TF32 off; pickles the
    outputs and the kernel's launches per run to ``out_path``."""
    import pickle

    import torch

    from retargetvid_tpu_torch.kernels.postprocess import saliency_postprocess
    from retargetvid_tpu_torch.parallel import distributed
    from retargetvid_tpu_torch.parallel.mesh import make_mesh
    from retargetvid_tpu_torch.parallel.runner import ShardedOneShot
    distributed.initialize(rank, 2, store, 'gloo', timeout_s=120)
    try:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        mesh = make_mesh(2, device='cuda:0')
        runner = ShardedOneShot(mesh, *small_models('cuda'),
                                dtype=torch.float32, tn_fullseq=True)
        res = {'coords': mesh.coords, 'device': str(mesh.device),
               'backend': torch.distributed.get_backend()}
        for name, batch in (('batch', clips), ('swapped', clips[::-1])):
            saliency_postprocess.launches = 0
            res[name] = runner.run_batch(batch, cp, **kw)
            torch.cuda.synchronize()
            res[f'{name}_launches'] = saliency_postprocess.launches
    finally:
        distributed.shutdown()
    with open(out_path, 'wb') as fp:
        pickle.dump(res, fp)


def two_rank_check(clips, cp, kw, tmp: Path):
    """Two spawned ranks on the one card (gloo; NCCL refuses two ranks on
    one GPU) against a world of 1 in this process: the outputs follow the
    clip, and each rank's equal the world-1 outputs of its clip."""
    import multiprocessing
    import pickle

    import torch

    from retargetvid_tpu_torch.parallel.mesh import make_mesh
    from retargetvid_tpu_torch.parallel.runner import ShardedOneShot
    ctx = multiprocessing.get_context('spawn')
    outs = [tmp / f'rank{r}.pkl' for r in range(2)]
    procs = [ctx.Process(target=two_rank_main, args=(
        r, f'file://{tmp / "two_rank.store"}', str(outs[r]), clips, cp, kw))
        for r in range(2)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + 300
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    if codes != [0, 0] or not all(o.exists() for o in outs):
        fail(f'sharded: the two gloo ranks exited with {codes}')
    ranks = [pickle.loads(o.read_bytes()) for o in outs]
    with exact_float32():
        single = ShardedOneShot(make_mesh(device='cuda'),
                                *small_models('cuda'), dtype=torch.float32,
                                tn_fullseq=True)
        world1 = [single.run_batch([c], cp, **kw)[0] for c in clips]
    for r, res in enumerate(ranks):
        for name, order in (('batch', (0, 1)), ('swapped', (1, 0))):
            for got, i in zip(res[name], order):
                want = world1[i]
                if (got['fc_sel'], got['n_segments']) != (
                        want['fc_sel'], want['n_segments']) or \
                        not np.array_equal(got['boxes'], want['boxes']):
                    fail(f'sharded: rank {r}, {name}: clip {i} differs from '
                         f'its world-1 outputs')
            if res[f'{name}_launches'] != 1:
                fail(f'sharded: rank {r} launched the kernel '
                     f'{res[f"{name}_launches"]} times for one batch')
    return {'coords': [res['coords'] for res in ranks],
            'backend': [res['backend'] for res in ranks],
            'devices': [res['device'] for res in ranks],
            'launches_per_rank_per_batch': [
                [res['batch_launches'], res['swapped_launches']]
                for res in ranks],
            'fc': [int(c.shape[0]) for c in clips],
            'fc_sel': [o['fc_sel'] for o in world1],
            'n_segments': [o['n_segments'] for o in world1],
            'outputs_follow_the_clip': True,
            'equal_to_world_1': True}


def phase_sharded(card, bench, program):
    """The sharded runners on a world of 1 over NCCL at full width, in
    turns with their single-device programs, the float32 exactness
    checks, then the two-rank routing check.  Returns the launches of each
    path."""
    import math
    import shutil
    import tempfile

    import torch

    from retargetvid_tpu_torch.ops.boxes import calc_dest_size
    from retargetvid_tpu_torch.parallel import distributed
    from retargetvid_tpu_torch.parallel.mesh import make_mesh
    from retargetvid_tpu_torch.parallel.runner import (
        ShardedClipRunner,
        ShardedOneShot,
        ShardedSaliency,
    )
    from retargetvid_tpu_torch.models.transnet import TransNetPredictor
    from retargetvid_tpu_torch.pipeline.fused import FusedClipProgram
    from retargetvid_tpu_torch.pipeline.ingest import _resize_kernel, sal_dims
    from retargetvid_tpu_torch.pipeline.saliency import SaliencyPredictor
    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix='chip_smoke_sharded_'))
    h, w = bench.h, bench.w
    resize = _resize_kernel(h, w, *sal_dims(w, h, bench.cp['max_input_d']))
    profile = TransNetPredictor(cut_detector())
    kw = dict(bench.kw, h_orig=h, w_orig=w)
    clips12 = [clip_structure(torch.from_numpy(
        make_clip(seed=s, shot_len=40)).cuda(), bench.cp, resize, profile)
        for s in (100, 0, 1, 2, 3)]
    with torch.inference_mode():
        sal0 = resize(bench.clips[0])[1]
    picks = sal0[list(range(0, 480, 6)) + [479]].cpu().numpy()

    distributed.initialize(0, 1, f'file://{tmp / "world1.store"}', 'nccl',
                           timeout_s=300)
    try:
        mesh = make_mesh(device='cuda')
        backend = torch.distributed.get_backend()
        oneshot = ShardedOneShot(mesh, bench.tn, bench.un,
                                 dtype=torch.bfloat16, tn_fullseq=True)
        fused = FusedClipProgram(bench.un, dtype=torch.bfloat16)
        runner = ShardedClipRunner(mesh, bench.un, dtype=torch.bfloat16)
        predictor = SaliencyPredictor(bench.un)
        sal_runner = ShardedSaliency(mesh, bench.un)

        def run_fused(c):
            return fused.run(c['sal_frames'], c['selected'], c['true_inds'],
                             c['segmentation'], c['segmentation_sel'],
                             bench.cp, fc=c['fc'], **kw)

        runs = {
            'oneshot': ({'sharded': lambda c: oneshot.run_batch(
                [c], bench.cp, **bench.kw)[0],
                'single': lambda c: program.run(c, bench.cp, **bench.kw)},
                [bench.warm] + bench.clips),
            'clip_runner': ({'sharded': lambda c: runner.run_batch(
                [c], bench.cp, **kw)[0], 'single': run_fused}, clips12),
            'saliency': ({'sharded': sal_runner.predict,
                          'single': predictor.predict}, [picks] * 5),
        }
        rec, launches = {}, {}
        for path, (fns, data) in runs.items():
            ms, outs, n = in_turns(fns, data[:1])           # warm-up
            ms, outs, n = in_turns(fns, data[1:])
            launches[path] = n['sharded']
            rec[path] = {f'{k}_per_run_ms': v for k, v in ms.items()}
            rec[path].update({f'{k}_median_ms': statistics.median(v)
                              for k, v in ms.items()})
            rec[path]['sharded_over_single'] = \
                rec[path]['sharded_median_ms'] / rec[path]['single_median_ms']
            rec[path]['launches'] = n
            if path == 'saliency':
                rec[path]['frames_per_s'] = {
                    k: len(picks) / statistics.median(v) * 1e3
                    for k, v in ms.items()}
                rec[path]['maps_max_lsb_vs_single'] = [
                    max_abs_diff(a, b) for a, b in zip(outs['sharded'],
                                                     outs['single'])]
            else:
                for out in outs['sharded']:
                    check_boxes(out['boxes'], bench.dest, h, w)
                rec[path]['boxes_max_px_vs_single'] = [
                    max_abs_diff(a['boxes'], b['boxes'])
                    for a, b in zip(outs['sharded'], outs['single'])]
        expect_launches('sharded_oneshot', launches['oneshot'], 4)
        expect_launches('sharded_clip_runner', launches['clip_runner'], 4)
        want = 4 * math.ceil(len(picks) / (mesh.shape['dp']
                                           * sal_runner.per_chip))
        if launches['saliency'] != want:
            fail(f'sharded_saliency: {launches["saliency"]} launches, '
                 f'expected {want}')
        exact = sharded_exact(mesh, bench, clips12[1], picks)
    finally:
        distributed.shutdown()

    small = [small_clip(fc) for fc in (52, 60)]
    dest = calc_dest_size(small[0].shape[2], small[0].shape[1], '1:3')
    two = two_rank_check(small, bench.cp, dict(
        fps=30.0, w_final=dest['w_final'], h_final=dest['h_final']), tmp)
    shutil.rmtree(tmp, ignore_errors=True)
    emit(card, phase='sharded', world=1, backend=backend,
         mesh=dict(mesh.shape), clip=[480, h, w], dtype='bfloat16 (TransNet '
         'and the UNISAL input); ShardedSaliency float32',
         tn_plan='fullseq', fc_cap=512, saliency_frames=len(picks),
         saliency_per_chip=sal_runner.per_chip, runs=rec,
         exact_float32=exact, two_rank_gloo=two, launches=launches,
         seconds=time.perf_counter() - t_phase)
    return {'sharded_oneshot': launches['oneshot'],
            'sharded_clip_runner': launches['clip_runner'],
            'sharded_saliency': launches['saliency'],
            'sharded_two_rank_per_rank': sum(
                two['launches_per_rank_per_batch'][0])}


def profile_clip(card, run, out_dir: Path, name: str):
    """``torch.profiler`` over one more clip (``run()``): device busy time
    against the wall time, kernel launches, and the per-operator table
    (written to ``out_dir/profile_<name>.txt``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
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


#: The test suite's narrow UNISAL (``tests/conftest.py:TINY_UNISAL_CFG``).
TINY_UNISAL = dict(cnn_widen_factor=0.25, cnn_last_channel=None,
                   rnn_input_channels=32, rnn_hidden_channels=32,
                   smoothing_ksize=11, smoothing_rank=4)


def small_models(device):
    """Full-width TransNet (head biased) and the narrow UNISAL of the test
    suite (with its ConvGRU, registered after every other module), from the
    same seeds on every device."""
    import torch

    from retargetvid_tpu_torch.models.init import seeded_init_
    from retargetvid_tpu_torch.models.transnet import TransNetV1
    from retargetvid_tpu_torch.models.unisal import UNISAL
    tn = seeded_init_(TransNetV1(), 0)
    with torch.no_grad():
        tn.dense2.bias.copy_(torch.tensor([5.0, -5.0]))
    return tn.to(device), seeded_init_(UNISAL(**TINY_UNISAL), 1).to(device)


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
    from retargetvid_tpu_torch.pipeline.geometry import pad_clip_tables
    from retargetvid_tpu_torch.pipeline.ingest import sample_frames
    fc, h, w = 150, 140, 250
    probs = np.zeros(fc, np.float32)
    probs[[59, 64]] = 0.9
    _, true_inds, m2o = sample_frames(fc, probs, 6, fc)
    seg = fix_scene_bounds(predictions_to_scenes(probs, 0.1), fc)
    seg_sel = scenes_to_selected(seg, m2o)
    sel_mask, ti, seg_cols = pad_clip_tables(true_inds, seg, seg_sel)
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:h, 0:w]
    t_sel = len(true_inds)
    maps = np.zeros((len(ti), h, w), np.float32)
    for i, f in enumerate(true_inds):
        cx = w * (0.2 + 0.6 * f / fc) if f < 60 else w * (0.8 - 0.4 * f / fc)
        cy = h * (0.5 + 0.2 * np.sin(f / 10.0))
        maps[i] = 250 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 400.0)
        maps[i] += (rng.random((h, w)) < 0.02) * rng.uniform(0, 255, (h, w))
    maps[5] = 0.0
    return (torch.from_numpy(np.clip(maps, 0, 255).astype(np.uint8)),
            torch.from_numpy(sel_mask), t_sel, torch.from_numpy(ti),
            *(torch.from_numpy(c) for c in seg_cols), len(seg)), fc


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


class StreamCuts:
    """The real TransNet predictor's probabilities raised to 1 where
    :func:`cut_detector` finds a hard cut between two frames that are not
    all zero: the streaming contexts' zero overlap and tail are no cuts."""

    def __init__(self, tn, device):
        from retargetvid_tpu_torch.models.transnet import TransNetPredictor
        self.real = TransNetPredictor(tn, device=device)
        self.cuts = cut_detector()

    def __call__(self, context):
        import torch
        p = self.real(context)
        with torch.inference_mode():
            cut = self.cuts(context[None])[0]
            live = context.flatten(1).amax(dim=1) > 0
            live = torch.cat([live[:1], live[1:] & live[:-1]])
        return np.maximum(p, (cut * live).cpu().numpy())


def stream_card_vs_cpu(name, models, cp):
    """A 96-frame 72x128 clip (a cut at frame 48) through ``segment_chunks``
    at ``read_batch=40`` and ``smart_vid_crop`` on the card and on the CPU:
    picks and shots must be equal, boxes within 1 px."""
    from retargetvid_tpu_torch.pipeline.saliency import SaliencyPredictor
    frames = small_clip(fc=96)
    cp = dict(cp, read_batch=40)
    vds = {}
    for dev in ('cuda', 'cpu'):
        tn, un = models[dev]
        vds[dev] = stream_crop(frames, cp, StreamCuts(tn, dev),
                               SaliencyPredictor(un, device=dev).predict,
                               device=dev)[0]
    gpu, cpu = vds['cuda'], vds['cpu']
    if gpu['true_inds'] != cpu['true_inds'] or not np.array_equal(
            gpu['segmentation'], cpu['segmentation']):
        fail(f'streaming small clip, {name}: picks or shots differ between '
             f'card and CPU')
    if len(gpu['segmentation']) != 2:
        fail(f'streaming small clip, {name}: {len(gpu["segmentation"])} '
             f'shots, expected 2')
    box_err = int(np.abs(np.asarray(gpu['bbs'])
                         - np.asarray(cpu['bbs'])).max())
    if box_err > 1:
        fail(f'streaming small clip, {name}: card and CPU boxes differ by '
             f'{box_err} px')
    return {'fc_sel': gpu['fc_sel'], 'shots': len(gpu['segmentation']),
            'max_box_px': box_err}


def predict_video_card_vs_cpu(models):
    """A 24-frame 72x128 clip through ``predict_video`` on the card and on
    the CPU, plain and with ``med3``: maps within 1 LSB; and on the card
    ``seq_len`` 2 against 9 within 1 LSB.  Returns the differing pixels."""
    from retargetvid_tpu_torch.pipeline.saliency import SaliencyPredictor
    frames = small_clip(fc=24)
    preds = {d: SaliencyPredictor(models[d][1], device=d)
             for d in ('cuda', 'cpu')}
    rec = {}
    for smooth in (None, 'med3'):
        maps = {d: p.predict_video(frames, smooth_method=smooth)
                for d, p in preds.items()}
        short = preds['cuda'].predict_video(frames, smooth_method=smooth,
                                            seq_len=2)
        long = preds['cuda'].predict_video(frames, smooth_method=smooth,
                                           seq_len=9)
        for label, a, b in (('card vs CPU', maps['cuda'], maps['cpu']),
                            ('seq_len 2 vs 9', short, long)):
            diff = np.abs(a.astype(np.int16) - b.astype(np.int16))
            if diff.max() > 1:
                fail(f'predict_video small clip, smooth={smooth}, {label}: '
                     f'{int(diff.max())} LSB apart')
            rec[f'{label}, smooth={smooth}'] = {
                'differing_px': int((diff > 0).sum()), 'of_px': diff.size,
                'max_lsb': int(diff.max())}
    return rec


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
    stream = {name: stream_card_vs_cpu(name, models, cp)
              for name, cp in presets.items()}
    dynamic = predict_video_card_vs_cpu(models)
    train = train_card_vs_cpu()
    emit(card, phase='exact_float32', dtype='float32', tf32=False,
         kernel_vs_plain_boxes_differing_frames=n_box_diff,
         ism_geometry_focus_card_vs_cpu=focus,
         fc_sel=fc_sel, n_segments=n_segments,
         windowed_probs_vs_predictor_max_abs=probs_err,
         multi_ratio_boxes_equal_to_run=True,
         small_clip_card_vs_cpu_max_box_px=box_err,
         stream_small_clip_card_vs_cpu=stream, tolerance_px=1,
         predict_video_small_clip=dynamic, predict_video_tolerance_lsb=1,
         train_steps_card_vs_cpu=train)


def main():
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--profile', metavar='DIR', default=None,
                        help='also profile one clip of the main path, the '
                             'ISM main path, the streaming phases and '
                             'predict_video with torch.profiler and write '
                             'the tables to DIR')
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
    record['launches_by_path']['crop_stream'] = phase_crop_stream(
        card, bench, profile_dir=args.profile)
    record['launches_by_path']['ism_crop_stream'] = phase_crop_stream(
        card, bench, ism_params(), 'ism_crop_stream', args.profile)
    record['launches_by_path']['cli_crop_pickle'] = phase_cli_crop_pickle(
        card, bench)
    (record['launches_by_path']['predict_video'],
     record['launches_by_path']['predict_video_med41']) = \
        phase_predict_video(card, bench, args.profile)
    (record['launches_by_path']['train_run_inference'],
     record['launches_by_path']['train_run_inference_static']) = \
        phase_train(card, bench, args.profile)
    record['launches_by_path'].update(phase_sharded(card, bench, program))
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
