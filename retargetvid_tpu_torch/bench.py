"""Single-GPU end-to-end pipeline throughput benchmark.

Counterpart of ``bench.py`` (the JAX system's), with its protocol: the
synthetic DHF1K-like clip (480 frames of 640x360 at 30 fps, a moving
Gaussian blob over seeded noise), the ICIP crop parameters at 1:3,
full-width TransNetV1 in bf16 and full-width UNISAL with seeded weights
(float32 parameters on a bf16 input, as the one-shot path runs it), from
uint8 frames already on the device to crop boxes on the host.  Decoding is
not timed; the weights are random (throughput does not depend on them).

    python -m retargetvid_tpu_torch.bench

Paths, chosen by the environment as in ``bench.py``:

- default: ``pipeline.oneshot.OneShotClipProgram`` (one program per clip:
  resizes, TransNet, sampling and scenes on the device, saliency, the
  postprocess kernel, geometry) with the full-sequence TransNet plan;
  ``BENCH_TN_FULLSEQ=0`` the 100/50 window plan;
- ``BENCH_MULTI_RATIO=1``: ``dispatch_multi`` serving 1:3 and 3:1 from one
  pass (``value`` stays video frames per second);
- ``BENCH_ONESHOT=0``: the two-dispatch path (ingest resizes and the
  windowed ``TransNetPredictor``, timed; a one-cut probability profile
  drives host sampling and scenes; ``FusedClipProgram.run``);
- ``BENCH_BATCH=B``: ``parallel.runner.ShardedOneShot`` on a process group
  of one rank (NCCL on the card) and ``make_mesh(1)``, B clips per
  ``run_batch`` over a sliding window of the clip pool.

The one-shot and batch paths bias TransNet's head (``dense2.bias = [5,
-5]``) so that random weights do not call every frame a cut; sampling then
takes every 6th frame.

Protocol: warm-up clips from seeds ``100 + i``, never timed; ``BENCH_ITERS``
(4) fresh clips from seeds ``0..``, on the device and synchronized before
the clock starts.  Per-clip: the median of dispatch to host boxes.
Pipelined (``BENCH_PIPELINE``: ``0``, ``1`` or ``both``, the default; one-
shot paths with B = 1 only): dispatch all, then collect all, over fresh
clips from seeds ``200 + s``.  ``BENCH_VERBOSE`` adds a cProfile of one
warm run and the per-clip seconds; ``BENCH_TRACE_DIR`` a ``torch.profiler``
trace of one pass (CPU and CUDA activities) as a Chrome trace.  The JAX
bench's ``BENCH_PALLAS_PP`` has no counterpart: the port always launches
its postprocess kernel (``pipeline/fused.py``).

The baseline is the reference's GPU-PC figure, t = exec_time / duration =
19% at 1:3 with the ICIP settings: 30 / 0.19 video frames per second.

Prints one JSON line: ``bench.py``'s keys (``metric``, ``value``,
``unit``, ``vs_baseline``, ``protocol``, ``tn_plan``,
``ratios_per_dispatch``, ``per_clip_fps``, ``pipelined_fps``) plus
``device`` (the card's name and power limit) and ``allow_tf32`` (cuDNN's
TF32 setting of the run).  Without a GPU it raises.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import subprocess
import tempfile
import time
from typing import Callable, Optional

import numpy as np
import torch

__all__ = ["make_clip", "run_bench", "card_line", "REFERENCE_FPS", "main"]

REFERENCE_FPS = 30.0 / 0.19     # the reference's GPU PC, frames/sec

#: Bias of TransNet's last layer on the one-shot and batch paths.
HEAD_BIAS = (5.0, -5.0)


def make_clip(n_frames: int = 480, h: int = 360, w: int = 640,
              seed: int = 0, shot_len: Optional[int] = None) -> np.ndarray:
    """``bench.py:make_clip``: a moving Gaussian blob over seeded noise,
    (n_frames, h, w, 3) uint8; with ``shot_len``, the noise is drawn anew
    every ``shot_len`` frames: a hard cut."""
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
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _sync(device: torch.device) -> None:
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def _world_of_one(device: torch.device):
    """A process group of this one process (NCCL on the card, gloo on the
    CPU) for the batch path, left afterwards; an existing group is used
    as it is."""
    import torch.distributed as dist

    from retargetvid_tpu_torch.parallel import distributed
    if dist.is_initialized():
        yield
        return
    tmp = tempfile.mkdtemp(prefix='rtv_bench_')
    distributed.initialize(0, 1, f'file://{os.path.join(tmp, "store")}',
                           'nccl' if device.type == 'cuda' else 'gloo')
    try:
        yield
    finally:
        distributed.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)


def _set_head_bias(tn_model) -> None:
    with torch.no_grad():
        tn_model.dense2.bias.copy_(torch.tensor(HEAD_BIAS))


def _paths(tn_model, un_model, *, n_frames, h, w, batch, oneshot,
           tn_fullseq, multi_ratio, dtype, device, cp, mesh):
    """(run_once, dispatch_once, collect_once) of the chosen path; the
    last two are None where the path has no split."""
    from retargetvid_tpu_torch.ops.boxes import calc_dest_size
    fps = 30.0
    dest = calc_dest_size(w, h, cp['out_ratio'])
    kw = dict(fps=fps, w_final=dest['w_final'], h_final=dest['h_final'])
    if batch > 1:
        from retargetvid_tpu_torch.parallel.runner import ShardedOneShot
        _set_head_bias(tn_model)
        sharded = ShardedOneShot(mesh, tn_model, un_model, dtype=dtype,
                                 tn_fullseq=tn_fullseq)
        return (lambda clips: sharded.run_batch(clips, cp, **kw)), None, None
    if oneshot:
        from retargetvid_tpu_torch.pipeline.oneshot import OneShotClipProgram
        _set_head_bias(tn_model)
        program = OneShotClipProgram(tn_model, un_model, dtype=dtype,
                                     tn_fullseq=tn_fullseq, device=device)
        if multi_ratio:
            dest31 = calc_dest_size(w, h, '3:1')
            dests = [(dest['w_final'], dest['h_final']),
                     (dest31['w_final'], dest31['h_final'])]

            def dispatch_once(clip):
                return program.dispatch_multi(clip, cp, fps=fps,
                                              dests=dests)

            return ((lambda clip: program.collect_multi(
                dispatch_once(clip))), dispatch_once, program.collect_multi)

        def dispatch_once(clip):
            return program.dispatch(clip, cp, **kw)

        return ((lambda clip: program.collect(dispatch_once(clip))),
                dispatch_once, program.collect)

    from retargetvid_tpu_torch.models.transnet import TransNetPredictor
    from retargetvid_tpu_torch.ops.scenes import (
        fix_scene_bounds,
        predictions_to_scenes,
        scenes_to_selected,
    )
    from retargetvid_tpu_torch.pipeline.fused import FusedClipProgram
    from retargetvid_tpu_torch.pipeline.ingest import (
        TRANS_THRESHOLD,
        _resize_kernel,
        sal_dims,
        sample_frames,
    )
    resize = _resize_kernel(h, w, *sal_dims(w, h, cp['max_input_d']))
    tn_predict = TransNetPredictor(tn_model.to(dtype), device=device)
    fused = FusedClipProgram(un_model, dtype=dtype, device=device)
    # Random weights call every frame a cut; time the real windowed
    # forward, but drive sampling from one hard cut, as bench.py does.
    synth_probs = np.zeros(n_frames, np.float32)
    synth_probs[n_frames // 2] = 1.0

    def run_once(clip):
        with torch.inference_mode():
            tn_frames, sal_frames = resize(clip)
        tn_predict(tn_frames)
        selected, true_inds, map2orig = sample_frames(
            n_frames, synth_probs, cp['skip'], n_frames)
        seg = fix_scene_bounds(
            predictions_to_scenes(synth_probs, TRANS_THRESHOLD), n_frames)
        seg_sel = scenes_to_selected(seg, map2orig)
        return fused.run(sal_frames, selected, true_inds, seg, seg_sel, cp,
                         h_orig=h, w_orig=w, fc=n_frames, **kw)

    return run_once, None, None


def _boxes(out) -> np.ndarray:
    """The first clip's (first ratio's) boxes of a path's outputs."""
    while isinstance(out, list):
        out = out[0]
    return out['boxes']


def run_bench(tn_model, un_model, *, n_frames: int = 480, h: int = 360,
              w: int = 640, iters: int = 4, batch: int = 1,
              oneshot: bool = True, tn_fullseq: bool = True,
              multi_ratio: bool = False, pipeline: str = 'both',
              dtype=torch.bfloat16, device=None,
              clip_fn: Optional[Callable[[int], torch.Tensor]] = None,
              verbose: bool = False, trace_dir: Optional[str] = None):
    """Time one path under ``bench.py``'s protocol; returns (the result
    dict, the outputs) with the outputs ``{'per_clip': [...],
    'pipelined': [...]}``, one entry per timed clip (under ``batch`` a list
    of B outputs; under ``multi_ratio`` one per ratio).

    ``tn_model``/``un_model`` are ``TransNetV1`` and ``UNISAL`` modules
    (the one-shot and batch paths set TransNet's head bias in place, as
    ``bench.py`` does); ``dtype`` is TransNet's and the UNISAL input's.
    ``clip_fn(seed)`` gives the uint8 clip of a seed on the device (default:
    :func:`make_clip` uploaded).  ``device=None`` means the GPU.
    """
    from retargetvid_tpu_torch.config import sc_init_crop_params
    from retargetvid_tpu_torch.device import resolve_device
    if pipeline not in ('0', '1', 'both'):
        raise ValueError(f"pipeline must be '0', '1' or 'both', got "
                         f'{pipeline!r}')
    device = resolve_device(device)
    if clip_fn is None:
        def clip_fn(seed):
            return torch.from_numpy(make_clip(n_frames, h, w, seed)).to(
                device)
    cp = sc_init_crop_params()
    cp['out_ratio'] = '1:3'
    if not oneshot and batch == 1:
        tn_fullseq = False      # the two-dispatch path times the window plan
    pipelined_capable = batch == 1 and oneshot
    do_pipelined = pipelined_capable and pipeline in ('1', 'both')
    do_per_clip = pipeline in ('0', 'both') or not pipelined_capable

    n_pool = iters if batch == 1 else iters + batch - 1
    warm = [clip_fn(100 + i) for i in range(batch)]
    clips = [clip_fn(s) for s in range(n_pool)]
    _sync(device)
    if batch == 1:
        warm = warm[0]

    with contextlib.ExitStack() as stack:
        mesh = None
        if batch > 1:
            from retargetvid_tpu_torch.parallel.mesh import make_mesh
            stack.enter_context(_world_of_one(device))
            mesh = make_mesh(1, device=device)
        run_once, dispatch_once, collect_once = _paths(
            tn_model, un_model, n_frames=n_frames, h=h, w=w, batch=batch,
            oneshot=oneshot, tn_fullseq=tn_fullseq, multi_ratio=multi_ratio,
            dtype=dtype, device=device, cp=cp, mesh=mesh)

        boxes = _boxes(run_once(warm))            # warm-up, never timed
        if boxes.shape != (n_frames, 4):
            raise RuntimeError(f'warm-up boxes {boxes.shape} != '
                               f'({n_frames}, 4)')
        if verbose:
            import cProfile
            import pstats
            prof = cProfile.Profile()
            prof.enable()
            run_once(warm)
            prof.disable()
            pstats.Stats(prof).sort_stats('cumulative').print_stats(25)
        if trace_dir:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if device.type == 'cuda' else [])
            with profile(activities=acts) as prof:
                run_once(warm)
                _sync(device)
            os.makedirs(trace_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(trace_dir,
                                                  'bench_trace.json'))

        outputs = {'per_clip': [], 'pipelined': []}
        per_clip_fps = pipelined_fps = None
        if do_per_clip:
            times = []
            for i in range(iters):
                arg = clips[i] if batch == 1 else clips[i:i + batch]
                _sync(device)
                t0 = time.perf_counter()
                outputs['per_clip'].append(run_once(arg))
                times.append(time.perf_counter() - t0)
            per_clip_fps = n_frames * batch / float(np.median(times))
            if verbose:
                print('per-clip seconds:', times)
        if do_pipelined:
            # Fresh clips, never dispatched before.
            pipe = [clip_fn(200 + s) for s in range(iters)]
            _sync(device)
            t0 = time.perf_counter()
            tickets = [dispatch_once(c) for c in pipe]
            for ticket in tickets:
                out = collect_once(ticket)
                if _boxes(out).shape != (n_frames, 4):
                    raise RuntimeError('pipelined boxes of the wrong shape')
                outputs['pipelined'].append(out)
            pipelined_fps = n_frames * iters / (time.perf_counter() - t0)

    headline = per_clip_fps if per_clip_fps is not None else pipelined_fps
    result = {
        'metric': f'end-to-end crop pipeline throughput ({w}x{h} video '
                  'frames/sec, single GPU)',
        'value': headline,
        'unit': 'frames/sec',
        'vs_baseline': headline / REFERENCE_FPS,
        'protocol': ('per_clip_median' if per_clip_fps is not None
                     else 'pipelined'),
        'tn_plan': 'fullseq' if tn_fullseq else 'windowed',
        'ratios_per_dispatch': 2 if multi_ratio and oneshot and batch == 1
                               else 1,
        'device': card_line() if device.type == 'cuda' else str(device),
        'allow_tf32': bool(torch.backends.cudnn.allow_tf32),
    }
    if per_clip_fps is not None:
        result['per_clip_fps'] = per_clip_fps
    if pipelined_fps is not None:
        result['pipelined_fps'] = pipelined_fps
    return result, outputs


def build_models(seed: int = 0):
    """Seeded full-width TransNetV1 and UNISAL (``chip_smoke.py``'s)."""
    from retargetvid_tpu_torch.models.init import seeded_init_
    from retargetvid_tpu_torch.models.transnet import TransNetV1
    from retargetvid_tpu_torch.models.unisal import UNISAL
    return seeded_init_(TransNetV1(), seed), seeded_init_(UNISAL(), seed + 1)


def main() -> dict:
    """Run the path the environment names on the GPU and print the JSON
    line; raises without a GPU."""
    from retargetvid_tpu_torch.device import resolve_device
    device = resolve_device(None)
    env = os.environ
    tn_model, un_model = build_models()
    result, _ = run_bench(
        tn_model, un_model, iters=int(env.get('BENCH_ITERS', '4')),
        batch=int(env.get('BENCH_BATCH', '1')),
        oneshot=env.get('BENCH_ONESHOT', '1') != '0',
        tn_fullseq=env.get('BENCH_TN_FULLSEQ', '1') != '0',
        multi_ratio=bool(env.get('BENCH_MULTI_RATIO')),
        pipeline=env.get('BENCH_PIPELINE', 'both'), device=device,
        verbose=bool(env.get('BENCH_VERBOSE')),
        trace_dir=env.get('BENCH_TRACE_DIR') or None)
    print(json.dumps(result), flush=True)
    return result


if __name__ == '__main__':
    main()
