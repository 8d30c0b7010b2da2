#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Run from the root of a checkout.  It drives the port's paths -- the
one-shot clip program, raw frames to crop boxes, the two-dispatch path, the
streaming ingest with ``smart_vid_crop`` and the ``crop`` command, dynamic
(ConvGRU) saliency, UNISAL training, the sharded runners and mesh
training, the throughput bench and the MFU tool -- at full model width
and fails (exit code != 0) if any phase fails:

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
  (b2) filtfilt kernel vs plain version: ``kernels/filtfilt.py:
      butter_filtfilt`` at the bench clip's (16, 512) low-pass input under
      the ICIP design (order 5, cutoff 2, 30 fps: 3 sections, padlen 18),
      on seeded random walks with live lengths 480, 1, padlen, padlen + 1,
      L - 1 and L: 0 differing values allowed.  ``ms_device_warm`` from
      the CUDA-graph timer on one input, ``ms_device`` with a 64 MB write
      between launches (past the 50 MB L2) less that write's own time,
      ``ms_call``, the plain version's device time (a CUDA graph of its
      ~49,300 launches) and per call, and the latency bound of the state
      update that carries from step to step: 2 passes x (3 dependent
      float32 operations x N steps + 2 per section to fill the cascade)
      x 4 cycles at the card's maximum SM clock;
  (b3) bn_act kernel vs plain version: ``kernels/bn_act.py:bn_act`` at the
      static forward's largest BatchNorm input (96, 96, 128, 208)
      channels-last in its three forms (ReLU6, alone, residual add), no
      more than 2^-20 of the terms' size from the plain version (eval
      ``F.batch_norm``, ``torch.clamp``, ``+``); ``ms_device`` (two 0.98
      GB inputs in turn) and ``ms_device_warm`` (one) from the CUDA-graph
      timer, ``ms_call``, the plain version's device time, cuDNN's eval
      BatchNorm alone (one pass over the same bytes), and the bytes bound
      at 3.35 TB/s; the main path must launch it 64 times a clip;
  (b4) smoothing-tail kernel: ``kernels/smooth.py:saliency_smooth`` at the
      static forward's (96, 1, 32, 52) -> 256x416, 8 factors of 41 taps
      (the bench UNISAL's factors of both sources, and random ones), and at
      a ConvGRU chunk's (6, 1, 32, 52), within float32 FMA's worst case of
      the formula in float64 (k (1 + r) / 2 units of 2^-23 of the terms'
      magnitudes); ``ms_device`` (100 inputs in turn, past the L2) and
      ``ms_device_warm`` from the CUDA-graph timer, ``ms_call``, the plain
      version's time a call (nearest resize, replicate pad, two convs; its
      host uploads keep it out of a CUDA graph),
      cuDNN's two convolutions alone on the padded map (TF32 as the card
      defaults) as the yardstick, and the float32 FMA bound at 67 TFLOP/s;
      one launch per static forward, per ConvGRU chunk, none in training;
  (c) main path: ``OneShotClipProgram.run`` with the full-sequence
      TransNet plan on the synthetic 480x360x640 clip of ``bench.py``
      (30 fps, 1:3 ratio), full-width TransNetV1 and UNISAL with seeded
      random weights, bf16; warm-up on seed 100, median of seeds 0..3,
      per-stage CUDA-event times; boxes checked against the frame and the
      destination size; the kernels' launches counted (one of each per
      clip) and the counter ``lowpass_kernel_rows`` (x and y of every
      padded segment per clip);
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
  (o) mesh training (``train_mesh``): the full-width DHF1K step (4, 12,
      224, 384), backbone trained, statistics drawn from a seed, from one
      seeded tree: on a 1-rank NCCL mesh against the plain ``Trainer``
      step in float32 with TF32 off (the loss summands within 1e-5
      relative, every parameter and statistic within 1e-5 + 1e-4
      relative), then in turns with it (TF32 as the card defaults; median
      CUDA-event ms of 5 steps each after one warm-up), and
      ``run_inference`` of the mesh trainer on the bench clip (one
      launch); two spawned gloo ranks on the card at the meshes (2,1,1),
      (1,2,1) and (1,1,2) against the same plain step, each rank's
      first and second step ms and peak allocated bytes above what it
      held before, beside the plain step's (TF32 off); four spawned gloo
      ranks on the card at (1,4,1) on a DHF1K-shaped (4, 12, 96, 384)
      batch, whose 3 rows at 1/32 leave the last sp rank without rows,
      against the plain step on that batch (TF32 off), with the same
      per-rank numbers;
      ``dryrun.dryrun_multichip(4)`` on four CPU ranks (the
      (1,2,2) train step and the swap check);
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
      1e-4 in relative L2 on the card and on the CPU;
  (p) ``bench``: ``retargetvid_tpu_torch.bench.run_bench`` under
      ``bench.py``'s protocol on the bench models and clips (warm-up seed
      100, seeds 0..3 timed, 200..203 pipelined), in the default mode
      (one-shot, full-sequence plan, per-clip and pipelined), the window
      plan, multi-ratio, two-dispatch and ``BENCH_BATCH=2``
      (``ShardedOneShot`` on a 1-rank NCCL group): every timed clip's
      boxes in the frame, the kernel's launches one per clip (warm-up
      included), the batch mode's picks, shots and boxes equal to
      ``OneShotClipProgram.run``'s on the same clips; then ``python -m
      retargetvid_tpu_torch.bench`` as a subprocess, its last line parsed;
  (q) ``mfu``: ``retargetvid_tpu_torch.mfu`` on the bench models, both
      targets' counted FLOPs (equal to ``FlopCounterMode``'s), slope ms per
      forward, TFLOP/s and MFU against the peak of the convolutions' dtype,
      and the bench clip's model FLOPs with their time at the peaks as a
      share of each bench mode's per-clip time.

``--profile DIR`` adds one ``torch.profiler`` run of a clip on each of
the main path, the ISM main path, the two streaming phases and
``predict_video``, and of one DHF1K and one SALICON train step (device busy
time, idle share, kernel launches, the postprocess kernel's own device
time; the per-operator tables go to ``DIR/profile_<phase>.txt``).

Each phase prints one JSON line carrying the card's name and power limit;
then a line with every kernel's record (with its launches on each path,
counted by ``retargetvid_tpu_torch/kernels/build.py:LAUNCHES``),
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
from collections import Counter
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
    ``shot_len`` frames: a hard cut (``retargetvid_tpu_torch.bench``)."""
    from retargetvid_tpu_torch.bench import make_clip as bench_clip
    return bench_clip(n_frames, h, w, seed, shot_len)


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


#: The bench clip's low-pass input: x and y of 8 padded segments, 512 frames.
FILTFILT_SHAPE = (16, 512)
#: The ICIP preset's (lp_cutoff, fps, lp_order).
FILTFILT_DESIGN = (2.0, 30.0, 5)
#: Latency of a dependent float32 add or multiply on Hopper, cycles.
FP32_LATENCY_CYCLES = 4
#: Dependent float32 ops of a section's state update per step.
STATE_CHAIN_OPS = 3


def filtfilt_inputs(seed, padlen):
    """Seeded centre-like random walks on the card, (16, 512), with live
    lengths 480 (the bench clip's one segment), 1 (padding rows), padlen,
    padlen + 1, L - 1 and L."""
    import torch
    b, L = FILTFILT_SHAPE
    rng = np.random.default_rng(seed)
    x = 320.0 + np.cumsum(rng.normal(0, 3, (b, L)), axis=1)
    lengths = (480, 1, 1, padlen, padlen + 1, L - 1, L, 1)
    n = np.asarray([lengths[(r + seed) % len(lengths)] for r in range(b)])
    return (torch.from_numpy(x.astype(np.float32)).cuda(),
            torch.from_numpy(n.astype(np.int64)).cuda())


def sm_clock_mhz():
    """The card's maximum and current SM clocks (MHz)."""
    line = subprocess.run(
        ['nvidia-smi', '--query-gpu=clocks.max.sm,clocks.sm',
         '--format=csv,noheader,nounits'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    top, now = (float(v) for v in line.split(','))
    return top, now


def phase_filtfilt(card):
    import torch

    from retargetvid_tpu_torch.kernels.build import LAUNCHES
    from retargetvid_tpu_torch.kernels.filtfilt import (
        butter_filtfilt,
        butter_filtfilt_reference,
        launch_plan,
    )
    from retargetvid_tpu_torch.ops.filters import _butter_design
    padlen, sections = _butter_design(*FILTFILT_DESIGN)
    b, L = FILTFILT_SHAPE
    inputs = [filtfilt_inputs(seed, padlen) for seed in range(6)]
    launches_before = LAUNCHES['butter_filtfilt']
    n_diff = 0
    for x, n in inputs:
        got = butter_filtfilt(x, n, padlen, sections)
        want = butter_filtfilt_reference(x, n, padlen, sections)
        torch.cuda.synchronize()
        n_diff += int((got.view(torch.int32) != want.view(torch.int32)).sum())
    if LAUNCHES['butter_filtfilt'] != launches_before + len(inputs):
        fail('filtfilt kernel: not one launch per call')
    if n_diff:
        fail(f'filtfilt kernel: {n_diff} values differ from the plain '
             f'version')

    def kernel(xn):
        return butter_filtfilt(xn[0], xn[1], padlen, sections)

    def plain(xn):
        return butter_filtfilt_reference(xn[0], xn[1], padlen, sections)

    # 64 MB written between launches evicts the 50 MB L2; its own time is
    # taken alone and subtracted.
    flush = torch.empty(16 * 2 ** 20, device='cuda')
    with_flush = device_ms(lambda xn: (flush.zero_(), kernel(xn)), inputs)
    flush_ms = device_ms(lambda xn: flush.zero_(), inputs)
    del flush
    ms_warm = device_ms(kernel, inputs[:1])
    ms_call = call_ms(lambda: kernel(inputs[0]))
    plain_ms = device_ms(plain, inputs[:1], n=1, reps=3)
    plain_ms_call = call_ms(lambda: plain(inputs[0]), n=3)
    top_mhz, now_mhz = sm_clock_mhz()
    # The state update s0' = (m00*s0 + m01*s1) + v0*x carries from step to
    # step: 3 dependent ops per step whatever the section count, plus the
    # output's 2 ops per section once per pass as the cascade fills.
    steps = L + 2 * padlen
    fill_ops = 2 * len(sections)
    bound_ms = ((STATE_CHAIN_OPS * steps + fill_ops) * FP32_LATENCY_CYCLES
                * 2) / (top_mhz * 1e3)
    rec = {'name': 'butter_filtfilt', 'route': 'cuda',
           'source': 'retargetvid_tpu_torch/csrc/butter_filtfilt.cu',
           'replaces': 'none (the JAX package runs an XLA scan); the '
                       'port\'s plain op chain, kernels/filtfilt.py:'
                       'butter_filtfilt_reference',
           'shape': list(FILTFILT_SHAPE), 'design': list(FILTFILT_DESIGN),
           'sections': len(sections), 'padlen': padlen,
           'plan': launch_plan(b, L, padlen)._asdict(),
           'n_values': len(inputs) * b * L, 'n_diff': n_diff,
           'tolerance': '0 (bit-equal)',
           'ms_device': with_flush - flush_ms, 'ms_device_warm': ms_warm,
           'flush_ms': flush_ms, 'ms_call': ms_call, 'plain_ms': plain_ms,
           'plain_ms_call': plain_ms_call, 'bound_ms': bound_ms,
           'bound_by': f'latency of the state update: 2 passes x '
                       f'({STATE_CHAIN_OPS} dependent float32 ops x {steps} '
                       f'steps + {fill_ops} to fill the cascade) x '
                       f'{FP32_LATENCY_CYCLES} cycles at {top_mhz:g} MHz',
           'bound_share': bound_ms / ms_warm,
           'sm_clock_mhz': {'max': top_mhz, 'now': now_mhz},
           'library_ms': None,
           'launches_in_phase': LAUNCHES['butter_filtfilt'] - launches_before}
    emit(card, phase='filtfilt', **rec)
    return rec


#: The static forward's largest BatchNorm input, channels-last: block 2's
#: expanded 96 channels at 128x208, 96 picks (its BatchNorms take ReLU6).
BN_ACT_SHAPE = (96, 96, 128, 208)
#: The static forward's BatchNorms: one launch each per clip.
BN_ACT_PER_CLIP = 64
#: The kernel against its plain version: float32 rounding of the scale and
#: shift and the ops after them, on the size of the terms either order of
#: the arithmetic rounds (|x s| + |mean s| + |beta| + |r|), as
#: ``tests/test_torch_bn_act.py``.
BN_ACT_REL_TOL = 2.0 ** -20


#: The kernel's three forms on the path: (ReLU6, residual).
BN_ACT_FORMS = {'relu6': (True, False), 'alone': (False, False),
                'residual': (False, True)}


def bn_act_case(shape, with_res, seed, layout='nhwc'):
    """Seeded input, residual (or None) in ``layout`` and BatchNorm buffers
    on the card."""
    import torch
    gen = torch.Generator(device='cuda').manual_seed(seed)

    def values(*size, scale=1.0, shift=0.0):
        return torch.randn(size, generator=gen, device='cuda') * scale + shift

    def laid_out(t):
        return t.contiguous(memory_format=torch.channels_last
                            if layout == 'nhwc' else torch.contiguous_format)

    c = shape[1]
    x = laid_out(values(*shape, scale=3.0))
    res = laid_out(values(*shape)) if with_res else None
    stats = (values(c), values(c).abs() + 0.1, values(c, scale=0.5,
                                                       shift=1.0),
             values(c, scale=0.5))
    return x, res, stats


def bn_act_path_calls():
    """(C, H, W, layout, form) of each kernel call of one static forward of
    the bench's UNISAL over 96 picks, preprocessed as the main path
    preprocesses them."""
    import types

    import torch

    from retargetvid_tpu_torch import bench, mfu
    from retargetvid_tpu_torch.kernels import bn_act as kernel
    from retargetvid_tpu_torch.models import layers

    calls = []

    def record(x, mean, var, gamma, beta, eps, relu6=False, residual=None):
        form = ('relu6' if relu6 else 'alone' if residual is None
                else 'residual')
        calls.append((*x.shape[1:], kernel.layout_of(x), form))
        return kernel.bn_act(x, mean, var, gamma, beta, eps, relu6,
                             residual)

    un = bench.build_models()[1].cuda()
    gen = torch.Generator(device='cuda').manual_seed(4)
    frames = torch.randint(0, 256, (mfu.PICKS, *mfu.SAL_HW, 3),
                           generator=gen, device='cuda', dtype=torch.uint8)
    layers.bn_act_kernel = types.SimpleNamespace(
        bn_act=record, layout_of=kernel.layout_of)
    try:
        with torch.inference_mode():
            mfu.unisal_forward(un, frames)
    finally:
        layers.bn_act_kernel = kernel
    del un, frames
    torch.cuda.empty_cache()
    return calls


def bn_act_check(shape, layout, form, seed):
    """The kernel against its plain version and the exact value (float64)
    on seeded values: the worst error of each on the size of the terms
    either order of the arithmetic rounds, the kernel's x s + t and cuDNN's
    (x - mean) s + beta.  Fails past :data:`BN_ACT_REL_TOL` or where the
    output's strides are not the input's."""
    import torch

    from retargetvid_tpu_torch.kernels.bn_act import bn_act, bn_act_reference
    eps = 1e-5
    relu6, with_res = BN_ACT_FORMS[form]
    x, res, stats = bn_act_case(shape, with_res, seed, layout)
    got = bn_act(x, *stats, eps, relu6=relu6, residual=res)
    want = bn_act_reference(x, *stats, eps, relu6=relu6, residual=res)
    mean, var, gamma, beta = (v.double()[None, :, None, None] for v in stats)
    scale = gamma / torch.sqrt(var + eps)
    exact = x.double() * scale + (beta - mean * scale)
    if relu6:
        exact = exact.clamp(0.0, 6.0)
    size = (x.double().abs() + mean.abs()) * scale.abs() + beta.abs()
    if res is not None:
        exact += res.double()
        size += res.double().abs()
    rel = {'kernel_vs_plain': float(((got.double() - want.double()).abs()
                                     / size).max()),
           'kernel_vs_exact': float(((got.double() - exact).abs()
                                     / size).max()),
           'plain_vs_exact': float(((want.double() - exact).abs()
                                    / size).max())}
    if rel['kernel_vs_plain'] > BN_ACT_REL_TOL or got.stride() != x.stride():
        fail(f'bn_act kernel ({form}, {shape}, {layout}): '
             f'{rel["kernel_vs_plain"]} of the terms\' size from the plain '
             f'version (limit {BN_ACT_REL_TOL}), strides {got.stride()} for '
             f'{x.stride()}')
    return rel


def phase_bn_act(card):
    import torch

    from retargetvid_tpu_torch.kernels.bn_act import (
        bn_act,
        bn_act_reference,
        launch_plan,
    )
    from retargetvid_tpu_torch.kernels.build import LAUNCHES
    eps = 1e-5
    launches_before = LAUNCHES['bn_act']
    # Every (C, H, W) and layout the static forward gives the kernel, in
    # each of the three forms, at 96 picks.
    path = bn_act_path_calls()
    if len(path) != BN_ACT_PER_CLIP:
        fail(f'bn_act kernel: {len(path)} calls in a static forward, not '
             f'{BN_ACT_PER_CLIP}')
    shapes = sorted({call[:4] for call in path})
    launches_checked = LAUNCHES['bn_act']
    worst = {form: {} for form in BN_ACT_FORMS}
    for i, (c, h, w, layout) in enumerate(shapes):
        for form in BN_ACT_FORMS:
            rel = bn_act_check((BN_ACT_SHAPE[0], c, h, w), layout, form,
                               seed=100 + i)
            for key, v in rel.items():
                if v >= worst[form].get(key, -1.0):
                    worst[form][key] = v
                    if key == 'kernel_vs_plain':
                        worst[form]['at'] = [c, h, w, layout]
    if (LAUNCHES['bn_act'] - launches_checked
            != len(BN_ACT_FORMS) * len(shapes)):
        fail('bn_act kernel: not one launch per call')
    torch.cuda.empty_cache()

    inputs = [bn_act_case(BN_ACT_SHAPE, False, seed=s)
              for s in (2, 3)]

    def kernel(case):
        return bn_act(case[0], *case[2], eps, relu6=True)

    def plain(case):
        return bn_act_reference(case[0], *case[2], eps, relu6=True)

    def batch_norm_alone(case):
        return torch.nn.functional.batch_norm(case[0], *case[2],
                                              training=False, eps=eps)

    # Each input is 0.98 GB, far past the 50 MB L2: every launch finds its
    # input cold either way.
    ms_cold = device_ms(kernel, inputs, n=20, reps=5)
    ms_warm = device_ms(kernel, inputs[:1], n=20, reps=5)
    ms_call = call_ms(lambda: kernel(inputs[0]), n=10)
    plain_ms = device_ms(plain, inputs, n=10, reps=3)
    bn_alone_ms = device_ms(batch_norm_alone, inputs, n=10, reps=3)
    n_el = int(np.prod(BN_ACT_SHAPE))
    moved = 8 * n_el                                # read x, write y
    bound_ms = moved / H100_BYTES_PER_S * 1e3
    rec = {'name': 'bn_act', 'route': 'cuda',
           'source': 'retargetvid_tpu_torch/csrc/bn_act.cu',
           'replaces': 'none (the JAX package leaves the epilogue to XLA\'s '
                       'conv fusion); the port\'s three ops, kernels/'
                       'bn_act.py:bn_act_reference',
           'checked': {'shapes_on_path': [list(sh) for sh in shapes],
                       'calls_on_path': len(path),
                       'forms': list(BN_ACT_FORMS), 'picks': BN_ACT_SHAPE[0]},
           'shape': list(BN_ACT_SHAPE), 'layout': 'channels-last',
           'plan': launch_plan(BN_ACT_SHAPE, 'nhwc')._asdict(),
           'worst_rel_diff': worst, 'tolerance_rel': BN_ACT_REL_TOL,
           'ms_device': ms_cold, 'ms_device_warm': ms_warm,
           'ms_call': ms_call, 'plain_ms': plain_ms,
           'bound_ms': bound_ms,
           'bound_by': f'bytes: {moved} ({n_el} float32 read and written) '
                       f'at 3.35 TB/s',
           'bound_share': bound_ms / ms_cold,
           'achieved_bytes_per_s': moved / (ms_cold * 1e-3),
           'library_ms': None,
           'batch_norm_alone_ms': bn_alone_ms,
           'launches_in_phase': LAUNCHES['bn_act'] - launches_before}
    del inputs
    torch.cuda.empty_cache()
    emit(card, phase='bn_act', **rec)
    return rec


#: The static forward's smoothing tail on the bench clip: 96 picks of the
#: 32x52 adaptation map to the 256x416 network input, 8 factors of 41 taps.
SMOOTH_SHAPE = (96, 1, 32, 52)
SMOOTH_OUT = (256, 416)
#: ``predict_video``'s ConvGRU chunk: 6 frames of the same map.
SMOOTH_CHUNK = (6, 1, 32, 52)


def smooth_check(shape, kv, kh, seed):
    """The kernel against the formula in float64 on seeded maps: the worst
    error over the terms' magnitudes, and over float32 FMA's worst case
    (k (1 + r) / 2 units of 2^-23 of them), which it must not pass."""
    import torch

    from retargetvid_tpu_torch.kernels.smooth import (
        saliency_smooth,
        smooth_reference,
    )
    gen = torch.Generator(device='cuda').manual_seed(seed)
    x = torch.randn(shape, generator=gen, device='cuda') * 2.0
    got = saliency_smooth(x, kv, kh, SMOOTH_OUT).double()
    x64, kv64, kh64 = x.double(), kv.double(), kh.double()
    exact = smooth_reference(x64, kv64, kh64, SMOOTH_OUT)
    size = smooth_reference(x64.abs(), kv64.abs(), kh64.abs(), SMOOTH_OUT)
    r, k = kv.shape[0], kv.shape[2]
    bound = k * (1 + r) / 2 * 2.0 ** -23
    rel = float(((got - exact).abs() / size.clamp(min=1e-300)).max())
    if rel > bound:
        fail(f'saliency_smooth kernel {shape}: {rel} of the terms\' '
             f'magnitudes from float64 (limit {bound})')
    return {'rel_to_terms': rel, 'of_bound': rel / bound}


def phase_smooth(card):
    import torch
    from torch.nn import functional as F

    from retargetvid_tpu_torch import bench
    from retargetvid_tpu_torch.kernels.build import LAUNCHES
    from retargetvid_tpu_torch.kernels.smooth import flops as smooth_flops
    from retargetvid_tpu_torch.kernels.smooth import (
        launch_plan,
        saliency_smooth,
        smooth_reference,
    )
    from retargetvid_tpu_torch.ops.resize import resize
    launches_before = LAUNCHES['saliency_smooth']
    un = bench.build_models()[1]
    factors = {src: (getattr(un, f'smoothing_v_{src}').detach().cuda(),
                     getattr(un, f'smoothing_h_{src}').detach().cuda())
               for src in ('dhf1k', 'salicon')}
    del un
    gen = torch.Generator(device='cuda').manual_seed(7)
    factors['random'] = (torch.randn((8, 1, 41, 1), generator=gen,
                                     device='cuda'),
                         torch.randn((1, 8, 1, 41), generator=gen,
                                     device='cuda'))
    worst = {f'{name} {list(shape)}':
             smooth_check(shape, kv, kh, seed=10 + i)
             for i, (name, (kv, kh)) in enumerate(factors.items())
             for shape in (SMOOTH_SHAPE, SMOOTH_CHUNK)}
    if LAUNCHES['saliency_smooth'] - launches_before != len(worst):
        fail('saliency_smooth kernel: not one launch per call')

    kv, kh = factors['salicon']
    inputs = [torch.randn(SMOOTH_SHAPE, generator=gen, device='cuda')
              for _ in range(100)]                  # 64 MB, past the L2
    pad = kv.shape[2] // 2

    def kernel(x):
        return saliency_smooth(x, kv, kh, SMOOTH_OUT)

    def plain(x):
        return smooth_reference(x, kv, kh, SMOOTH_OUT)

    padded = [F.pad(resize(x, SMOOTH_OUT, 'nearest', channels_last=False),
                    (pad,) * 4, mode='replicate') for x in inputs[:2]]

    def cudnn_convs(xp):
        return F.conv2d(F.conv2d(xp, kv), kh)

    ms_cold = device_ms(kernel, inputs, n=100, reps=5)
    ms_warm = device_ms(kernel, inputs[:1], n=60, reps=5)
    ms_call = call_ms(lambda: kernel(inputs[0]))
    # The plain version uploads the nearest resize's index tables from the
    # host on every call, which a CUDA graph cannot capture: timed a call.
    plain_ms = call_ms(lambda: plain(inputs[0]), n=10)
    library_ms = device_ms(cudnn_convs, padded, n=10, reps=3)
    n, _, h, w = SMOOTH_SHAPE
    r, k = kv.shape[0], kv.shape[2]
    flops = smooth_flops(n, SMOOTH_OUT, r, k)
    bound_ms = flops / H100_FP32_FLOPS * 1e3
    # The function's own FMAs: a vertical sum depends on its column only
    # through the source column the nearest resize reads there, so it is
    # needed once per distinct source column (the kernel, as the
    # convolution, forms it at every padded column).
    out_h, out_w = SMOOTH_OUT
    src_cols = {min(int(min(max(x - k // 2, 0), out_w - 1) * (w / out_w)),
                    w - 1) for x in range(out_w + k - 1)}
    flops_distinct = 2 * n * r * out_h * k * (len(src_cols) + out_w)
    bound_distinct_ms = flops_distinct / H100_FP32_FLOPS * 1e3
    rec = {'name': 'saliency_smooth', 'route': 'cuda',
           'source': 'retargetvid_tpu_torch/csrc/saliency_smooth.cu',
           'replaces': 'none (the JAX package leaves the tail to XLA); the '
                       'port\'s nearest resize, replicate pad and two '
                       'convolutions, kernels/smooth.py:smooth_reference',
           'shape': [list(SMOOTH_SHAPE), list(SMOOTH_OUT)], 'r': r, 'k': k,
           'plan': launch_plan(n, h, w, *SMOOTH_OUT, r, k)._asdict(),
           'worst_vs_float64': worst,
           'ms_device': ms_cold, 'ms_device_warm': ms_warm,
           'ms_call': ms_call, 'plain_ms': plain_ms,
           'plain_timed': 'a call (call_ms): its host uploads keep it out '
                          'of a CUDA graph',
           'bound_ms': bound_ms,
           'bound_by': f'float32 FMA: {flops} FLOP (vertical at the padded '
                       f'columns, horizontal) at 67 TFLOP/s',
           'bound_share': bound_ms / ms_cold,
           'achieved_flop_per_s': flops / (ms_cold * 1e-3),
           'bound_distinct_ms': bound_distinct_ms,
           'bound_distinct_by': f'float32 FMA: {flops_distinct} FLOP '
                                f'(vertical at the {len(src_cols)} distinct '
                                f'source columns, horizontal) at 67 TFLOP/s',
           'bound_distinct_share': bound_distinct_ms / ms_cold,
           'library_ms': library_ms,
           'library': 'cuDNN F.conv2d vertical then horizontal on the '
                      'padded map, TF32 as the card defaults',
           'launches_in_phase': LAUNCHES['saliency_smooth']
           - launches_before}
    del inputs, padded
    torch.cuda.empty_cache()
    emit(card, phase='saliency_smooth', **rec)
    return rec


def build_models(seed=0):
    """The bench's seeded full-width models, TransNet's head biased as
    bench.py does (random weights fire a "cut" on every frame), so sampling
    runs its realistic every-skip regime."""
    import torch

    from retargetvid_tpu_torch import bench
    tn, un = bench.build_models(seed)
    with torch.no_grad():
        tn.dense2.bias.copy_(torch.tensor(bench.HEAD_BIAS))
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


#: Each kernel's launches on each path (a ``Counter`` by library name per
#: path): the kernel records' ``launches_by_path``.
LAUNCHES_BY_PATH = {}


@contextlib.contextmanager
def launches_of(path=None):
    """Count the kernels' launches in the block: yields a ``Counter``, with
    a key for every kernel, filled when the block ends and added to
    ``path``'s in :data:`LAUNCHES_BY_PATH`."""
    from retargetvid_tpu_torch.kernels.build import KERNEL_SOURCES, LAUNCHES
    LAUNCHES.clear()
    got = Counter()
    yield got
    got.update({name: LAUNCHES[name] for name in KERNEL_SOURCES})
    if path is not None:
        LAUNCHES_BY_PATH.setdefault(path, Counter()).update(got)


def expect_launches(path, n_clips, cp, forwards=None, got=None):
    """Fail unless ``path`` (or the count ``got``) launched each kernel as
    ``n_clips`` clips of a crop path should: the postprocess kernel once
    and ``bn_act`` once per BatchNorm and ``saliency_smooth`` once in each
    static UNISAL forward (``forwards``: one a clip on the one-shot paths,
    one per 32 picks on the streaming ones), the filtfilt kernel once a
    clip where ``cp`` low-passes."""
    forwards = n_clips if forwards is None else forwards
    want = {'saliency_postprocess': forwards,
            'butter_filtfilt': n_clips if cp['lp_filt'] else 0,
            'bn_act': BN_ACT_PER_CLIP * forwards,
            'saliency_smooth': forwards}
    got = LAUNCHES_BY_PATH[path] if got is None else got
    if any(got[name] != n for name, n in want.items()):
        fail(f'{path}: launches {dict(got)} for {n_clips} clips (expected '
             f'{want})')


def drive(run, warm, clips, path, program=None):
    """``run`` on the warm-up clip, then on each clip, the kernels'
    launches counted under ``path``: per-clip ms, outputs and, with
    ``program``, its median stage times."""
    import torch

    from retargetvid_tpu_torch.pipeline.oneshot import StageTimer
    run(warm)
    timer = StageTimer()
    if program is not None:
        program.timer = timer
    times, outs = [], []
    with launches_of(path):
        for clip in clips:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs.append(run(clip))
            times.append((time.perf_counter() - t0) * 1e3)
    if program is not None:
        program.timer = None
    stages = {k: statistics.median(v) for k, v in timer.times_ms().items()}
    return times, outs, stages


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


def phase_main_path(card, bench, profile_dir=None):
    import torch

    from retargetvid_tpu_torch.pipeline.oneshot import OneShotClipProgram
    program = OneShotClipProgram(bench.tn, bench.un, dtype=torch.bfloat16,
                                 tn_fullseq=True)
    times, outs, stages = drive(
        lambda c: program.run(c, bench.cp, **bench.kw), bench.warm,
        bench.clips, 'main_path', program)
    expect_launches('main_path', len(bench.clips), bench.cp)
    rows = stages.get('lowpass_kernel_rows', 0)
    if rows != 2 * program.s_pad:
        fail(f'main path: lowpass_kernel_rows {rows} per clip, expected '
             f'{2 * program.s_pad} (x and y of {program.s_pad} segments)')
    for out in outs:
        bench.check(out)
    med = statistics.median(times)
    got = LAUNCHES_BY_PATH['main_path']
    emit(card, phase='main_path', clip=[480, bench.h, bench.w],
         dtype='bfloat16', tn_plan='fullseq', per_clip_ms=times,
         median_ms=med, frames_per_s=480 / med * 1e3,
         fc_sel=[o['fc_sel'] for o in outs],
         n_segments=[o['n_segments'] for o in outs],
         stage_median_ms=stages,
         postprocess_launches=got['saliency_postprocess'],
         filtfilt_launches=got['butter_filtfilt'],
         bn_act_launches=got['bn_act'])
    if profile_dir is not None:
        profile_clip(card, lambda: program.run(bench.clips[0], bench.cp,
                                               **bench.kw),
                     Path(profile_dir), 'main_path')
    return program, outs, stages


def phase_ism(card, bench, profile_dir=None):
    """The main path under the ISM preset; returns the program."""
    import torch

    from retargetvid_tpu_torch.pipeline.oneshot import OneShotClipProgram
    cp = ism_params()
    program = OneShotClipProgram(bench.tn, bench.un, dtype=torch.bfloat16,
                                 tn_fullseq=True)
    times, outs, stages = drive(
        lambda c: program.run(c, cp, **bench.kw), bench.warm, bench.clips,
        'ism_main_path', program)
    expect_launches('ism_main_path', len(bench.clips), cp)
    for out in outs:
        bench.check(out)
    med = statistics.median(times)
    got = LAUNCHES_BY_PATH['ism_main_path']
    emit(card, phase='ism_main_path', preset='ISM-2021',
         clip=[480, bench.h, bench.w], dtype='bfloat16', tn_plan='fullseq',
         per_clip_ms=times, median_ms=med, frames_per_s=480 / med * 1e3,
         fc_sel=[o['fc_sel'] for o in outs],
         n_segments=[o['n_segments'] for o in outs],
         **focus_stats(outs, cp, bench.fps), boxes_in_frame_at_dest=True,
         stage_median_ms=stages,
         postprocess_launches=got['saliency_postprocess'],
         filtfilt_launches=got['butter_filtfilt'])
    if profile_dir is not None:
        profile_clip(card, lambda: program.run(bench.clips[0], cp,
                                               **bench.kw),
                     Path(profile_dir), 'ism_main_path')
    return program


def phase_windowed(card, bench, main_outs, main_stages):
    import torch

    from retargetvid_tpu_torch.pipeline.oneshot import OneShotClipProgram
    program = OneShotClipProgram(bench.tn, bench.un, dtype=torch.bfloat16)
    if program.tn_fullseq:
        fail('the one-shot program does not default to the window plan')
    times, outs, stages = drive(
        lambda c: program.run(c, bench.cp, **bench.kw), bench.warm,
        bench.clips, 'windowed_plan', program)
    expect_launches('windowed_plan', len(bench.clips), bench.cp)
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
         postprocess_launches=LAUNCHES_BY_PATH['windowed_plan'][
             'saliency_postprocess'])


def phase_multi_ratio(card, bench, program, cp=None, phase='multi_ratio'):
    """``dispatch_multi`` for both ratios and the two ``run`` calls it
    replaces, in turns on each clip (multi first on even clips, runs first
    on odd ones), the kernels' launches of each counted.  ``cp`` defaults
    to the bench's ICIP parameters."""
    import torch

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
    two_runs = Counter()
    for i, clip in enumerate(bench.clips):
        order = ('multi', 'runs') if i % 2 == 0 else ('runs', 'multi')
        for name in order:
            program.timer = timer if name == 'multi' else None
            torch.cuda.synchronize()
            with launches_of(phase if name == 'multi' else None) as got:
                t0 = time.perf_counter()
                outs[name].append((multi if name == 'multi' else runs)(clip))
                ms[name].append((time.perf_counter() - t0) * 1e3)
            if name == 'runs':
                two_runs.update(got)
    program.timer = None
    expect_launches(phase, len(bench.clips), cp)
    expect_launches(f'{phase}, two runs', 2 * len(bench.clips), cp,
                    got=two_runs)
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
         postprocess_launches=LAUNCHES_BY_PATH[phase]['saliency_postprocess'])


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
    outs, shots, parts = [], [], []
    with launches_of(phase):
        for clip in clips:
            out, n_seg, ms = two_dispatch(clip, cp, kw, resize, fused,
                                          profile, real)
            outs.append(out)
            shots.append(n_seg)
            parts.append(ms)
    fused.timer = None
    expect_launches(phase, len(clips), cp)
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
         fused_stage_median_ms=stages,
         postprocess_launches=LAUNCHES_BY_PATH[phase]['saliency_postprocess'])


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


def phase_crop_stream(card, bench, cp=None, phase='crop_stream',
                      profile_dir=None):
    """The streaming path on the bench clips (host uint8 frames in
    256-frame chunks), in turns with the one-shot window-plan program on
    the same clips; ``cp`` defaults to the bench's ICIP parameters."""
    import torch

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
    launches, stages, picks, series = [], [], [], []
    for i, (clip, frames) in enumerate(zip(bench.clips, host)):
        order = ('stream', 'oneshot') if i % 2 == 0 else ('oneshot',
                                                          'stream')
        got = {}
        for name in order:
            torch.cuda.synchronize()
            with launches_of(phase if name == 'stream' else None) \
                    as got[name]:
                t0 = time.perf_counter()
                if name == 'stream':
                    vd, res, times = stream(frames)
                else:
                    oneshot(clip)
                ms[name].append((time.perf_counter() - t0) * 1e3)
        check_boxes(np.asarray(vd['bbs']), bench.dest, bench.h, bench.w)
        if res['result'] != 'smart cropped':
            fail(f'{phase}: result {res["result"]!r}')
        picks.append(vd['fc_sel'])
        series.append({'jumps': np.asarray(vd['jumps']),
                       'fc_sel': vd['fc_sel']})
        stages.append(times)
        expect_launches(phase, 1, cp, forwards=-(-vd['fc_sel'] // 32),
                        got=got['stream'])
        expect_launches(f'{phase}, one-shot windowed', 1, cp,
                        got=got['oneshot'])
        launches.append(got['stream']['saliency_postprocess'])
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
         fc_sel=picks, **extra, launches_per_clip=launches,
         boxes_in_frame_at_dest=True,
         oneshot_windowed_f32_per_clip_ms=ms['oneshot'],
         oneshot_windowed_median_ms=one_med,
         oneshot_stage_median_ms=one_stages,
         stream_over_oneshot=med / one_med)
    if profile_dir is not None:
        profile_clip(card, lambda: stream(host[0]), Path(profile_dir), phase)


def phase_cli_crop_pickle(card, bench):
    """``cli crop`` on the 12-shot clip written as a reference ``.pkl``,
    plain and with ``--best-settings``."""
    import pickle
    import tempfile

    from retargetvid_tpu_torch import cli
    from retargetvid_tpu_torch.eval.annotations import read_boxes_file
    from retargetvid_tpu_torch.pipeline.ingest import sample_frames
    frames = make_clip(seed=0, shot_len=40)
    fc = len(frames)
    trans_inds = list(range(39, fc - 1, 40))            # 11 cuts
    probs = np.zeros(fc, np.float32)
    probs[trans_inds] = 1.0
    picks = len(sample_frames(fc, probs, bench.cp['skip'], fc)[1])
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        pkl = Path(tmp) / 'clip.pkl'
        with open(pkl, 'wb') as fp:
            pickle.dump({'fr': bench.fps, 'frame_count': fc, 'w': bench.w,
                         'h': bench.h, 'frames': frames,
                         'trans_inds': trans_inds}, fp)
        for preset, extra, cp in (('icip', [], bench.cp),
                                  ('ism', ['--best-settings'], ism_params())):
            out = Path(tmp) / f'out_{preset}'
            with launches_of('cli_crop_pickle') as got:
                t0 = time.perf_counter()
                cli.main(['crop', str(pkl), '--ratio', '1:3', '--save-vid',
                          '--out', str(out)] + extra)
                wall = time.perf_counter() - t0
            expect_launches(f'cli_crop_pickle {preset}', 1, cp,
                            forwards=-(-picks // 32), got=got)
            boxes = read_boxes_file(f'{out}.txt')
            check_boxes(boxes, bench.dest, bench.h, bench.w)
            with open(Path(tmp) / 'clip_sc.pkl', 'rb') as fp:
                cropped = pickle.load(fp)
            want = np.stack([f[y1:y2, x1:x2]
                             for f, (x1, y1, x2, y2) in zip(frames, boxes)])
            if not np.array_equal(cropped['frames'], want):
                fail(f'cli_crop_pickle {preset}: clip_sc.pkl does not hold '
                     f'the frames cropped by the boxes')
            runs[preset] = {'wall_s': wall,
                            'launches': got['saliency_postprocess'],
                            'sc_frames': list(cropped['frames'].shape)}
    emit(card, phase='cli_crop_pickle', clip=[fc, bench.h, bench.w],
         shots=len(trans_inds) + 1, picks=picks, runs=runs,
         boxes_in_frame_at_dest=True)


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
    ``med41`` in turns."""
    import torch

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
                with launches_of('predict_video' if mode == 'none'
                                 else f'predict_video_{mode}') as got:
                    chunks[0] = 0
                    t0 = time.perf_counter()
                    maps = predictor.predict_video(clip,
                                                   smooth_method=modes[mode])
                    ms[mode].append((time.perf_counter() - t0) * 1e3)
                launches[mode].append(got['saliency_postprocess'])
                n_chunks[mode].append(chunks[0])
                if got['saliency_smooth'] != chunks[0]:
                    fail(f'predict_video {mode}: {got["saliency_smooth"]} '
                         f'smoothing launches for {chunks[0]} chunks')
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


def train_batches(source, n, seed, shape=None):
    """``n`` seeded numpy batches of ``source``'s shape (or ``shape``),
    moved to the card: normal frames, saliency normalized to a
    distribution per frame, 0.5% of pixels fixated."""
    import torch
    b, t, h, w = shape or TRAIN_SHAPES[source]
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
    """UNISAL training at full width (see the module docstring, (m))."""
    import tempfile

    import torch

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
    with launches_of('train_steps') as got:
        for i in range(10):
            ov.state, _ = step(ov.state, *batch)
            if i == 0:
                check_stats_moved(moved_stats(before, ov.model),
                                  ('dhf1k',), 'one DHF1K step')
    if got['bn_act'] or got['saliency_smooth']:
        fail(f'train: the train steps launched {dict(got)}')
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
        with launches_of('train_run_inference' if label == 'dynamic'
                         else 'train_run_inference_static') as got:
            t0 = time.perf_counter()
            maps, inf_scores = tr.run_inference(frames, source=source,
                                                sal=sal[:len(frames)],
                                                fix=fix[:len(frames)])
            ms[f'{label}_maps_and_scores'] = (time.perf_counter() - t0) * 1e3
        launches[label] = got['saliency_postprocess']
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


def in_turns(runs, clips, path=None):
    """Each of ``runs`` (name -> fn(clip)) on each clip, the order flipped
    every clip, a synchronised host clock around each; the kernels'
    launches of each run counted (with ``path``, the ``sharded`` run's under
    it).  Returns per-run ms lists, outputs and the postprocess kernel's
    launch totals."""
    import torch

    names = list(runs)
    ms = {n: [] for n in names}
    outs = {n: [] for n in names}
    launches = dict.fromkeys(names, 0)
    for i, clip in enumerate(clips):
        for name in (names if i % 2 == 0 else names[::-1]):
            torch.cuda.synchronize()
            with launches_of(path if name == 'sharded' else None) as got:
                t0 = time.perf_counter()
                outs[name].append(runs[name](clip))
                torch.cuda.synchronize()
                ms[name].append((time.perf_counter() - t0) * 1e3)
            launches[name] += got['saliency_postprocess']
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
    outputs and the kernels' launches per run to ``out_path``."""
    import pickle

    import torch

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
            with launches_of() as res[f'{name}_launches']:
                res[name] = runner.run_batch(batch, cp, **kw)
                torch.cuda.synchronize()
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
            n = res[f'{name}_launches']['saliency_postprocess']
            if n != 1:
                fail(f'sharded: rank {r} launched the kernel {n} times for '
                     f'one batch')

    def per_rank_per_batch(kernel):
        return [[res[f'{name}_launches'][kernel]
                 for name in ('batch', 'swapped')] for res in ranks]

    return {'coords': [res['coords'] for res in ranks],
            'backend': [res['backend'] for res in ranks],
            'devices': [res['device'] for res in ranks],
            'launches_per_rank_per_batch': per_rank_per_batch(
                'saliency_postprocess'),
            'filtfilt_launches_per_rank_per_batch': per_rank_per_batch(
                'butter_filtfilt'),
            'fc': [int(c.shape[0]) for c in clips],
            'fc_sel': [o['fc_sel'] for o in world1],
            'n_segments': [o['n_segments'] for o in world1],
            'outputs_follow_the_clip': True,
            'equal_to_world_1': True}


def phase_sharded(card, bench, program):
    """The sharded runners on a world of 1 over NCCL at full width, in
    turns with their single-device programs, the float32 exactness
    checks, then the two-rank routing check."""
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
            ms, outs, n = in_turns(fns, data[1:], f'sharded_{path}')
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
        expect_launches('sharded_oneshot', 4, bench.cp)
        expect_launches('sharded_clip_runner', 4, bench.cp)
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
    LAUNCHES_BY_PATH['sharded_two_rank_per_rank'] = Counter(
        saliency_postprocess=sum(two['launches_per_rank_per_batch'][0]),
        butter_filtfilt=sum(two['filtfilt_launches_per_rank_per_batch'][0]))


#: The meshes of two ranks sharing the card in the ``train_mesh`` phase.
TRAIN_MESHES = ((2, 1, 1), (1, 2, 1), (1, 1, 2))
#: Four ranks on the card: a DHF1K-shaped batch whose 3 rows at 1/32
#: leave the last sp rank without rows (1, 1, 1, 0).
ROW_MESH, ROW_SHAPE = (1, 4, 1), (4, 12, 96, 384)
#: The mesh step against the single-device step, TF32 off: the loss, then
#: every parameter and statistic (absolute + relative), as the CPU tests.
MESH_LOSS_RTOL, MESH_ATOL, MESH_RTOL = 1e-5, 1e-5, 1e-4


def mesh_step(tr, batch, seed=7):
    """One DHF1K step (backbone trained) of ``tr`` on the global ``batch``,
    through its blocks on a mesh; the step's metrics, its CUDA-event ms,
    ``torch.cuda.max_memory_allocated`` over the step and the bytes
    allocated before it."""
    import torch
    tr.generator.manual_seed(seed)
    x, sal, fix, layout = tr._shard_arrays(*batch)
    step = tr.step_fn('DHF1K', False, True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    tr.state, m = step(tr.state, x, sal, fix, layout)
    end.record()
    end.synchronize()
    return ({k: float(v) for k, v in m.items()}, start.elapsed_time(end),
            torch.cuda.max_memory_allocated(), base)


def trees_apart(got, ref, label):
    """Fails unless the loss summands and every leaf of the full trees
    agree within the ``MESH_*`` bounds; returns the largest differences."""
    def flat(tree, prefix=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, prefix + (k,))
            else:
                yield '/'.join(prefix + (k,)), np.asarray(v)

    (gm, gt), (rm, rt) = got, ref
    loss_err = max(abs(gm[k] - rm[k]) / max(abs(rm[k]), 1e-12) for k in rm)
    gt, rt = dict(flat(gt)), dict(flat(rt))
    if set(gt) != set(rt):
        fail(f'train_mesh {label}: the trees differ in their leaves')
    worst, bad = (0.0, None), []
    for k, ref_v in rt.items():
        d = np.abs(gt[k] - ref_v)
        if float(d.max()) > worst[0]:
            worst = (float(d.max()), k)
        if (d > MESH_ATOL + MESH_RTOL * np.abs(ref_v)).any():
            bad.append(k)
    if loss_err > MESH_LOSS_RTOL or bad:
        fail(f'train_mesh {label}: loss {gm} against {rm}, leaves out of '
             f'bounds {bad[:6]}')
    return {'metrics_max_rel_diff': loss_err, 'max_abs_diff': worst[0],
            'max_abs_diff_at': worst[1]}


def mesh_rank_main(rank, world, store, out_path, tree_path, meshes,
                   shape=None):
    """One of ``world`` ranks on the one card over gloo: for each of
    ``meshes`` a mesh trainer from the pickled full tree, one step of the
    DHF1K batch (of ``shape``; TF32 off), the gathered tree (rank 0 keeps
    it), the step's ms and peak memory, then a second step's ms; pickled
    to ``out_path``."""
    import pickle

    import torch

    from retargetvid_tpu_torch.parallel import distributed
    from retargetvid_tpu_torch.parallel.mesh import make_mesh
    from retargetvid_tpu_torch.train.trainer import Trainer
    distributed.initialize(rank, world, store, 'gloo', timeout_s=300)
    res = {}
    try:
        with open(tree_path, 'rb') as fp:
            tree = pickle.load(fp)
        batch = train_batches('DHF1K', 1, 20, shape)[0]
        with exact_float32():
            for sizes in meshes:
                mesh = make_mesh(world, axis_sizes=sizes, device='cuda:0')
                tr = Trainer(device='cuda:0')
                tr.init_state(variables=tree, mesh=mesh)
                metrics, ms, peak, base = mesh_step(tr, batch)
                full = tr._flax_tree()
                warm_ms = mesh_step(tr, batch, seed=8)[1]
                res[sizes] = {'coords': mesh.coords, 'metrics': metrics,
                              'ms': ms, 'warm_ms': warm_ms,
                              'max_memory_allocated': peak,
                              'peak_bytes': peak - base,
                              'tp_split_weights': len(tr._tp_dims),
                              'tree': full if rank == 0 else None}
                del tr, full
                torch.cuda.empty_cache()
    finally:
        distributed.shutdown()
    with open(out_path, 'wb') as fp:
        pickle.dump(res, fp)


def spawn_ranks(target, tmp: Path, world, *args, timeout=600):
    """``target(rank, world, store, out_path, *args)`` on ``world``
    spawned ranks; their pickled results (fails on a rank that exits with an
    error or outlives ``timeout``)."""
    import multiprocessing
    import pickle
    ctx = multiprocessing.get_context('spawn')
    name = f'{target.__name__}_{world}'
    outs = [tmp / f'{name}.rank{r}.pkl' for r in range(world)]
    procs = [ctx.Process(target=target, args=(
        r, world, f'file://{tmp / (name + ".store")}', str(outs[r]), *args))
        for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    if codes != [0] * world or not all(o.exists() for o in outs):
        fail(f'{name}: the ranks exited with {codes}')
    return [pickle.loads(o.read_bytes()) for o in outs]


def gloo_ranks_record(ranks, meshes, single, single_peak, what):
    """Per mesh: every rank's coordinates, step ms and peak bytes, and
    rank 0's gathered tree against the plain step ``single`` (fails
    outside the ``MESH_*`` bounds or where the ranks' metrics differ)."""
    out = {}
    for sizes in meshes:
        rs = [r[sizes] for r in ranks]
        label = 'x'.join(map(str, sizes))
        if any(r['metrics'] != rs[0]['metrics'] for r in rs):
            fail(f'train_mesh {label}: the ranks report different metrics')
        out[label] = {
            'coords': [r['coords'] for r in rs],
            'tp_split_weights': rs[0]['tp_split_weights'],
            'first_step_ms': [r['ms'] for r in rs],
            'second_step_ms': [r['warm_ms'] for r in rs],
            'max_memory_allocated_per_rank': [r['max_memory_allocated']
                                              for r in rs],
            'peak_bytes_per_rank': [r['peak_bytes'] for r in rs],
            'peak_over_single': [r['peak_bytes'] / single_peak
                                 for r in rs],
            **trees_apart((rs[0]['metrics'], rs[0]['tree']), single,
                          f'{what} {label}')}
    return out


def phase_train_mesh(card, bench):
    """Mesh training at full width (see the module docstring, (o))."""
    import pickle
    import shutil
    import tempfile

    import torch

    from retargetvid_tpu_torch.dryrun import dryrun_multichip
    from retargetvid_tpu_torch.parallel import distributed
    from retargetvid_tpu_torch.parallel.mesh import make_mesh
    from retargetvid_tpu_torch.parallel.shard import split_rows
    from retargetvid_tpu_torch.train.trainer import Trainer
    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix='chip_smoke_train_mesh_'))
    batch = train_batches('DHF1K', 1, 20)[0]
    seeded = Trainer()
    seeded.init_state(rng_seed=0)
    draw_stats(seeded.model, 3)
    tree = seeded._flax_tree()
    del seeded

    def fresh(mesh=None):
        tr = Trainer()
        tr.init_state(variables=tree, mesh=mesh)
        return tr

    with exact_float32():
        plain = fresh()
        single_m, single_ms, single_max, base = mesh_step(plain, batch)
        single_peak = single_max - base
        single = (single_m, plain._flax_tree())
        single_warm_ms = mesh_step(plain, batch, seed=8)[1]
        plain = fresh()
        row_batch = train_batches('DHF1K', 1, 20, ROW_SHAPE)[0]
        row_m, row_ms, row_max, row_base = mesh_step(plain, row_batch)
        row_single_peak = row_max - row_base
        row_single = (row_m, plain._flax_tree())
        row_warm_ms = mesh_step(plain, row_batch, seed=8)[1]
        del plain, row_batch
    distributed.initialize(0, 1, f'file://{tmp / "world1.store"}', 'nccl',
                           timeout_s=300)
    try:
        mesh = make_mesh(device='cuda')
        backend = torch.distributed.get_backend()
        with exact_float32():
            tr = fresh(mesh)
            m, _, max1, base1 = mesh_step(tr, batch)
            world1 = trees_apart((m, tr._flax_tree()), single,
                                 '1-rank NCCL mesh')
            del tr
        # In turns with the plain step (TF32 as the card defaults).
        trainers = {'mesh': fresh(mesh), 'plain': fresh()}
        ms = {k: [] for k in trainers}
        for i in range(6):
            for k, tr in trainers.items():
                ms[k].append(mesh_step(tr, batch, seed=i)[1])
        ms = {k: v[1:] for k, v in ms.items()}            # warm-up out
        clip = bench.clips[0]
        with launches_of('train_mesh_run_inference') as got:
            maps, _ = trainers['mesh'].run_inference(clip, source='DHF1K')
            torch.cuda.synchronize()
        launches = got['saliency_postprocess']
        if launches != 1 or maps.shape != tuple(clip.shape[:3]):
            fail(f'train_mesh run_inference: {launches} launches, maps '
                 f'{maps.shape}')
        del trainers
    finally:
        distributed.shutdown()
    torch.cuda.empty_cache()

    with open(tmp / 'tree.pkl', 'wb') as fp:
        pickle.dump(tree, fp)
    two = gloo_ranks_record(
        spawn_ranks(mesh_rank_main, tmp, 2, str(tmp / 'tree.pkl'),
                    TRAIN_MESHES), TRAIN_MESHES, single, single_peak,
        'two gloo ranks')
    four = gloo_ranks_record(
        spawn_ranks(mesh_rank_main, tmp, 4, str(tmp / 'tree.pkl'),
                    (ROW_MESH,), ROW_SHAPE), (ROW_MESH,), row_single,
        row_single_peak, 'four gloo ranks')
    dry = dryrun_multichip(4, timeout_s=300.0)
    shutil.rmtree(tmp, ignore_errors=True)
    emit(card, phase='train_mesh', model='UNISAL full width, bn_train, '
         'dropout live, statistics drawn from a seed, float32',
         batch=list(TRAIN_SHAPES['DHF1K']), source='DHF1K',
         backbone='trained',
         world1={'backend': backend, 'mesh': dict(mesh.shape),
                 'step_ms_in_turns': ms,
                 'median_ms': {k: statistics.median(v)
                               for k, v in ms.items()},
                 'mesh_over_plain': statistics.median(ms['mesh'])
                 / statistics.median(ms['plain']),
                 'exact_float32_vs_plain': world1,
                 'peak_bytes': {'mesh': max1 - base1,
                                'plain': single_peak}},
         single_step_float32={'first_step_ms': single_ms,
                              'second_step_ms': single_warm_ms,
                              'max_memory_allocated': single_max,
                              'peak_bytes': single_peak,
                              'metrics': single_m},
         two_rank_gloo=two,
         four_rank_gloo_rows={
             'batch': list(ROW_SHAPE),
             # Five halvings keep the rows r % 32 == 0 of [s, e).
             'rows_per_sp_rank_at_1_32': [
                 -(-e // 32) + (-s // 32)
                 for s, e in split_rows(ROW_SHAPE[2], ROW_MESH[1])],
             'single_step_float32': {'first_step_ms': row_ms,
                                     'second_step_ms': row_warm_ms,
                                     'peak_bytes': row_single_peak,
                                     'metrics': row_m},
             **four},
         tolerance={'metrics_rel': MESH_LOSS_RTOL, 'atol': MESH_ATOL,
                    'rtol': MESH_RTOL},
         dryrun_multichip_4=dry, run_inference_launches=launches,
         seconds=time.perf_counter() - t_phase)


#: The bench modes of the ``bench`` phase: ``run_bench`` arguments and the
#: kernel launches they make (warm-up included; two clips per batch).
BENCH_MODES = {
    'bench_default': ({}, 1 + 4 + 4),
    'bench_windowed': ({'tn_fullseq': False}, 1 + 4 + 4),
    'bench_multi_ratio': ({'multi_ratio': True}, 1 + 4 + 4),
    'bench_two_dispatch': ({'oneshot': False}, 1 + 4),
    'bench_batch2': ({'batch': 2}, 2 + 4 * 2),
}


def bench_outputs(out):
    """The outputs dicts in one timed entry of ``run_bench`` (a clip, the
    ratios of a clip, or the clips of a batch)."""
    return out if isinstance(out, list) else [out]


def phase_bench(card, bench):
    """``retargetvid_tpu_torch.bench.run_bench`` in each mode of
    :data:`BENCH_MODES` on the bench models and clips (seeds 0..3 and the
    warm-up seed 100 shared with the other phases), then ``python -m
    retargetvid_tpu_torch.bench`` once as a subprocess.  Returns the
    records of each mode."""
    import os

    import torch

    from retargetvid_tpu_torch.bench import run_bench
    from retargetvid_tpu_torch.pipeline.oneshot import OneShotClipProgram
    t_phase = time.perf_counter()
    cache = {100: bench.warm, **dict(enumerate(bench.clips))}

    def clip_fn(seed):
        if seed not in cache:
            cache[seed] = torch.from_numpy(make_clip(seed=seed)).cuda()
        return cache[seed]

    records, launches, outputs = {}, {}, {}
    for name, (kw, want) in BENCH_MODES.items():
        torch.cuda.synchronize()
        with launches_of(name) as got:
            result, outs = run_bench(bench.tn, bench.un, clip_fn=clip_fn,
                                     **kw)
            torch.cuda.synchronize()
        launches[name] = got['saliency_postprocess']
        expect_launches(name, want, bench.cp)
        for entry in outs['per_clip'] + outs['pipelined']:
            for r, out in enumerate(bench_outputs(entry)):
                dest = bench.dests[r] if kw.get('multi_ratio') else None
                bench.check(out, dest)
        outputs[name] = outs
        rec = dict(result, seconds=time.perf_counter() - t_phase)
        rec['ms_per_clip'] = 480 / result['per_clip_fps'] * 1e3
        if 'pipelined_fps' in result:
            rec['pipelined_over_per_clip'] = (result['pipelined_fps']
                                              / result['per_clip_fps'])
        records[name] = rec

    # The batch mode against OneShotClipProgram.run on the same clips and
    # weights: the default mode's per-clip runs (seeds 0..3) and one run
    # of seed 4.
    single = {s: out for s, out in enumerate(
        outputs['bench_default']['per_clip'])}
    single[4] = OneShotClipProgram(bench.tn, bench.un, tn_fullseq=True).run(
        clip_fn(4), bench.cp, **bench.kw)
    box_px = []
    for i, batch in enumerate(outputs['bench_batch2']['per_clip']):
        for seed, got in zip((i, i + 1), batch):
            want = single[seed]
            if (got['fc_sel'], got['n_segments']) != (want['fc_sel'],
                                                      want['n_segments']):
                fail(f'bench_batch2: seed {seed} picks or shots differ '
                     'from OneShotClipProgram.run')
            box_px.append(max_abs_diff(got['boxes'], want['boxes']))
    if max(box_px):
        fail(f'bench_batch2: boxes differ from OneShotClipProgram.run by '
             f'{box_px} px')
    records['bench_batch2']['boxes_max_px_vs_oneshot_run'] = box_px
    del cache
    torch.cuda.empty_cache()

    repo = Path(__file__).resolve().parent
    proc = subprocess.run(
        [sys.executable, '-m', 'retargetvid_tpu_torch.bench'], cwd=repo,
        env=dict(os.environ, PYTHONPATH=str(repo)), capture_output=True,
        text=True, timeout=600)
    if proc.returncode != 0:
        fail(f'python -m retargetvid_tpu_torch.bench exited with '
             f'{proc.returncode}: {proc.stderr[-2000:]}')
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    missing = {'metric', 'value', 'unit', 'vs_baseline', 'protocol',
               'tn_plan', 'ratios_per_dispatch', 'per_clip_fps',
               'pipelined_fps', 'device', 'allow_tf32'} - set(line)
    if missing or line['device'] != card:
        fail(f'bench subprocess: keys {sorted(missing)} missing or device '
             f'{line.get("device")!r} is not {card!r}')
    records['bench_subprocess'] = line
    emit(card, phase='bench', clip=[480, bench.h, bench.w], iters=4,
         dtype='bfloat16 (TransNet and the UNISAL input)', modes=records,
         launches=launches, seconds=time.perf_counter() - t_phase)
    return records


def phase_mfu(card, bench, bench_records):
    """``retargetvid_tpu_torch.mfu`` on the bench models: both targets'
    counted FLOPs (equal to ``FlopCounterMode``'s), slope ms per forward,
    TFLOP/s and MFU, and the bench clip's model FLOPs with their share of
    each one-shot mode's per-clip time (at the peaks)."""
    from retargetvid_tpu_torch import mfu
    t_phase = time.perf_counter()
    rows = [mfu.measure(t, reps=5) for t in (mfu.unisal_target(bench.un),
                                             mfu.transnet_target(bench.tn))]
    for row in rows:
        if row['flops'] != row['counter_flops']:
            fail(f'mfu: {row["name"]}: counted {row["flops"]} FLOPs, '
                 f'FlopCounterMode {row["counter_flops"]}')
        if not 0 < row['mfu'] < 1:
            fail(f'mfu: {row["name"]}: MFU {row["mfu"]} outside (0, 1)')
    clip = mfu.clip_flops(bench.un, bench.tn)
    share = {}
    for name, rec in bench_records.items():
        if 'ms_per_clip' in rec:
            share[name] = (clip[f'clip_{rec["tn_plan"]}_ms_at_peak']
                           / rec['ms_per_clip'])
    emit(card, phase='mfu', rows=rows, clip_flops=clip,
         clip_share_of_peak=share,
         note='UNISAL: float32 parameters, TF32 convolutions (JAX\'s '
              'tools/mfu.py computes it in bf16); TransNet bf16',
         seconds=time.perf_counter() - t_phase)


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
    from retargetvid_tpu_torch.kernels.build import LAUNCHES
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
        before = LAUNCHES['saliency_postprocess']
        with_kernel = fullseq.run(clip, cp, **kw)
        if LAUNCHES['saliency_postprocess'] != before + 1:
            fail(f'{name}: the float32 run did not launch the kernel '
                 f'exactly once')
        with plain_postprocess():
            with_plain = fullseq.run(clip, cp, **kw)
        if LAUNCHES['saliency_postprocess'] != before + 1:
            fail(f'{name}: the plain run launched the kernel')
        n_box_diff[name] = int((with_kernel['boxes'] != with_plain['boxes'])
                               .any(1).sum())
        if n_box_diff[name]:
            fail(f'{name}: kernel and plain postprocess give different '
                 f'boxes on {n_box_diff[name]} frames')
        fc_sel[name] = with_kernel['fc_sel']
        n_segments[name] = with_kernel['n_segments']

        # dispatch_multi vs each ratio's run.
        before = LAUNCHES['saliency_postprocess']
        multi = fullseq.collect_multi(fullseq.dispatch_multi(
            clip, cp, fps=30.0,
            dests=[(d['w_final'], d['h_final']) for d in dests]))
        if LAUNCHES['saliency_postprocess'] != before + 1:
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
    filtfilt_record = phase_filtfilt(card)
    bn_act_record = phase_bn_act(card)
    smooth_record = phase_smooth(card)
    bench = Bench()
    program, main_outs, main_stages = phase_main_path(card, bench,
                                                      args.profile)
    phase_windowed(card, bench, main_outs, main_stages)
    phase_multi_ratio(card, bench, program)
    phase_two_dispatch(card, bench)
    ism_program = phase_ism(card, bench, args.profile)
    phase_multi_ratio(card, bench, ism_program, ism_params(),
                      'ism_multi_ratio')
    phase_two_dispatch(card, bench, ism_params(), 'ism_two_dispatch')
    phase_crop_stream(card, bench, profile_dir=args.profile)
    phase_crop_stream(card, bench, ism_params(), 'ism_crop_stream',
                      args.profile)
    phase_cli_crop_pickle(card, bench)
    phase_predict_video(card, bench, args.profile)
    phase_train(card, bench, args.profile)
    phase_sharded(card, bench, program)
    phase_train_mesh(card, bench)
    with exact_float32():
        phase_exact(card)
    bench_records = phase_bench(card, bench)
    phase_mfu(card, bench, bench_records)
    if 'jax' in sys.modules:
        fail('jax was imported')
    record['launches'] = LAUNCHES_BY_PATH['main_path']['saliency_postprocess']
    records = [record, filtfilt_record, bn_act_record, smooth_record]
    for rec in records:
        rec['launches_by_path'] = {path: got[rec['name']] for path, got
                                   in LAUNCHES_BY_PATH.items()
                                   if rec['name'] in got}
    print(json.dumps({'kernels': records}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
