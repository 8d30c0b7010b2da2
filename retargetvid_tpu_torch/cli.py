"""Command-line interface of the PyTorch port.

    python -m retargetvid_tpu_torch.cli {crop,benchmark,eval,predict,train,score}

Port of ``retargetvid_tpu/cli.py``'s user entry points, which mirror the
reference's:

- ``benchmark``: the ``python smartVidCrop.py`` benchmark loop
  (``smartVidCrop.py:2621-2846``): every video of a directory at the
  requested aspect ratios, ``NNN_<ar>.txt`` + ``NNN_<ar>_info.txt`` per
  video, inline IoU against the 6 annotators; ``--oneshot`` serves each
  video with one ``OneShotClipProgram.dispatch_multi`` for all ratios;
  ``--mesh N [--oneshot]`` splits the clips over N processes, one per GPU
  (``parallel.runner``; see :func:`cmd_benchmark`).
- ``crop``: smart-crop one video (or a reference-format ``.pkl``).
- ``eval``: the standalone ``retargetvid_eval.py`` evaluator.
- ``predict``: saliency maps of a folder of images or a video file
  (reference ``run.py predict_examples``), static or ``--dynamic``
  (the ConvGRU over interleaved frame-modulo sequences).
- ``train``: train UNISAL on the datasets located by ``DHF1K_DATA_DIR``
  etc. (reference ``run.py train`` -> ``Trainer.fit``), optionally
  ``--fine-tune-mit``; the run directory holds ``Trainer.json``, the
  checkpoints and the best weights in the JAX package's format.
- ``score``: score a trained run directory (reference ``run.py
  score_model``), rebuilt from its ``Trainer.json``.

Model weights: ``--unisal-weights`` (the reference's torch
``weights_best.pth``) and ``--transnet-weights`` (the ``{'params': ...}``
pickle of the TransNet converter; with ``--transnet-arch v2``, a state
dict saved from the published TransNet V2 PyTorch module, for example
``transnetv2-pytorch-weights.pth``); without them the models get seeded
random weights (throughput runs only: IoU numbers are meaningless).
``--device`` (default ``cuda``) is where everything runs; a missing GPU is
an error unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import glob
import os
import pickle
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

from retargetvid_tpu_torch.config import sc_init_crop_params, smart_crop_version
from retargetvid_tpu_torch.device import resolve_device


def _load_unisal(args):
    """Full-width UNISAL from ``--unisal-weights``, else seeded."""
    from retargetvid_tpu_torch.models.init import seeded_init_
    from retargetvid_tpu_torch.models.torch_import import load_unisal_state_dict
    from retargetvid_tpu_torch.models.unisal import UNISAL

    model = UNISAL()
    if args.unisal_weights:
        sd = torch.load(args.unisal_weights, map_location='cpu')
        if isinstance(sd, dict) and 'model_state_dict' in sd:
            sd = sd['model_state_dict']
        load_unisal_state_dict(model, sd)
        print(f' loaded UNISAL weights from {args.unisal_weights}')
    else:
        seeded_init_(model, 1)
        print(' WARNING: no --unisal-weights; using random init '
              '(throughput runs only)')
    return model


def _load_transnet(args):
    """The ``--transnet-arch`` model (V1 or V2) from
    ``--transnet-weights``, else seeded."""
    from retargetvid_tpu_torch.convert import load_flax_variables
    from retargetvid_tpu_torch.models.init import seeded_init_
    from retargetvid_tpu_torch.models.transnet import TransNetV1
    from retargetvid_tpu_torch.models.transnetv2 import TransNetV2

    v2 = getattr(args, 'transnet_arch', 'v1') == 'v2'
    if not args.transnet_weights:
        print(' WARNING: no --transnet-weights; using random init')
        return seeded_init_(TransNetV2() if v2 else TransNetV1(), 0)
    if v2:
        model = TransNetV2.from_state_dict(torch.load(
            args.transnet_weights, map_location='cpu', weights_only=True))
    else:
        model = TransNetV1()
        with open(args.transnet_weights, 'rb') as fp:
            load_flax_variables(model, pickle.load(fp))
    print(f' loaded TransNet weights from {args.transnet_weights}')
    return model


def _build_models(args):
    """(transnet_fn, saliency_fn) of the streaming path, float32."""
    from retargetvid_tpu_torch.models.transnet import TransNetPredictor
    from retargetvid_tpu_torch.pipeline.saliency import SaliencyPredictor

    predictor = SaliencyPredictor(_load_unisal(args), chunk=args.chunk,
                                  device=args.device)
    transnet_fn = TransNetPredictor(_load_transnet(args),
                                    fullseq=_tn_fullseq(args),
                                    device=args.device)
    return transnet_fn, predictor.predict


def _load_oneshot_models(args):
    """(TransNet, UNISAL) modules for the one-shot path."""
    tn = _load_transnet(args)
    return tn, _load_unisal(args)


def _sharded_models(args):
    """(transnet_fn, UNISAL) of ``benchmark --mesh``: the host-side shot
    detector of ``read_video_structure`` and the clip runner's model."""
    from retargetvid_tpu_torch.models.transnet import TransNetPredictor

    transnet_fn = TransNetPredictor(_load_transnet(args),
                                    fullseq=_tn_fullseq(args),
                                    device=args.device)
    return transnet_fn, _load_unisal(args)


def _tn_fullseq(args) -> bool:
    """Resolve the ``--tn-plan`` flag to the ``fullseq`` boolean."""
    return getattr(args, 'tn_plan', 'windowed') == 'fullseq'


def _eval_inline(annots, vid_fn, ar, bbs):
    from retargetvid_tpu_torch.eval.harness import (
        benchmark_eval_boxes,
        iou_xyxy_inclusive,
    )

    if annots is None or not vid_fn.isdigit():
        return
    vid_ind = int(vid_fn)
    pred = benchmark_eval_boxes(np.asarray(bbs, int), ar)
    user_means = []
    for user in range(len(annots)):
        gt = annots[user][ar.replace(':', '-')][vid_ind]
        n = min(len(gt), len(pred))
        ious = iou_xyxy_inclusive(
            np.maximum(gt[:n], 0), np.maximum(pred[:n], 0))
        user_means.append(float(ious.mean()))
        print('   user #%d: %.3f' % (user + 1, user_means[-1]))
    print('   mean   : %.3f' % statistics.mean(user_means))


def _write_info(path, info: dict) -> None:
    with open(path, 'w') as fp:
        for k, v in info.items():
            fp.write(f'{k}:{v}\n')


def _oneshot_info(cp, *, result, h, w, sal_hw, dest, boxes, fc, fps,
                  t_read, t_dev) -> dict:
    """One-shot results dict under the reference contracts
    (``smartVidCrop.py:2581-2610`` keys; timings in the
    ``<sec>s, <percent>%`` form the evaluator parses; the device phase
    reported under ``_clustering``, as the streaming path does)."""
    vid_dur = fc / fps if fps else 1.0

    def fmt(v):
        return '%7.3fs, %6.3f%%' % (v, v / vid_dur * 100.0)

    fbb_w = int(boxes[0][2] - boxes[0][0]) if len(boxes) else dest['w_final']
    fbb_h = int(boxes[0][3] - boxes[0][1]) if len(boxes) else dest['h_final']
    return {
        'result': result,
        'info': ' (%dx%d)->(%dx%d)->(%dx%d)->(%dx%d)\n' % (
            h, w, sal_hw[0], sal_hw[1], dest['h_final'],
            dest['w_final'], fbb_h, fbb_w),
        'params': ''.join(' %-18s : %s\n' % (k, str(v))
                          for k, v in cp.items()),
        'mean_sal_score': None, 'mean_sal_score_t': cp['t_sal'],
        'coverage_score': None, 'coverage_score_t': cp['t_cvrg'],
        'cuts_clust': 0,
        't__read': fmt(t_read),
        't__clustering': fmt(t_dev),
        't_total': fmt(t_read + t_dev),
    }


def cmd_benchmark_oneshot(args, vid_paths, results_out, annots, crop_params):
    """Per-video one-dispatch path (``pipeline.oneshot``): decode the whole
    clip, run resizes, shot detection, sampling, saliency and geometry for
    every missing ratio in one ``dispatch_multi``, and fall back to the
    streaming ``smart_vid_crop`` when a clip exceeds ``read_batch`` or the
    program's static pick/shot bounds (the JAX CLI's route)."""
    from retargetvid_tpu_torch.config import sal_dims
    from retargetvid_tpu_torch.eval.annotations import write_boxes_file
    from retargetvid_tpu_torch.io.native_reader import open_reader
    from retargetvid_tpu_torch.io.video import probe_video
    from retargetvid_tpu_torch.ops.boxes import calc_dest_size
    from retargetvid_tpu_torch.pipeline.oneshot import OneShotClipProgram

    tn_model, un_model = _load_oneshot_models(args)
    program = OneShotClipProgram(
        tn_model, un_model,
        tn_fullseq=crop_params.get('tpu_transnet_fullseq', False),
        device=args.device)

    def _finish(pend):
        """Collect a dispatched clip, write every ratio's outputs, eval
        inline."""
        (ticket, vid_path, vid_fn, jobs, meta, fc, t_read, t_disp) = pend
        fps, w, h = meta['fps'], meta['width'], meta['height']
        outs = None
        t_dev = t_disp
        if ticket is not None:
            t0 = time.perf_counter()
            try:
                outs = program.collect_multi(ticket)
            except ValueError as exc:
                print(f' oneshot fallback: {exc}')
            # Host-attributed device time: the dispatch call plus the
            # collect wait (the wall between them is the next clip's
            # decode).
            t_dev = t_disp + (time.perf_counter() - t0)
        for r, (ar, cp, txt, info_path, dest) in enumerate(jobs):
            if outs is None:
                from retargetvid_tpu_torch.pipeline.crop import smart_vid_crop
                transnet_fn, saliency_fn = _build_models(args)
                vd, res = smart_vid_crop(vid_path, cp, save_vid=False,
                                         transnet_fn=transnet_fn,
                                         saliency_fn=saliency_fn,
                                         device=args.device)
                boxes = np.asarray(vd['bbs'], int)
                _write_info(info_path, res)
            else:
                boxes = outs[r]['boxes']
                # Decode and device time amortize across the ratios served
                # by the one dispatch.
                _write_info(info_path, _oneshot_info(
                    cp, result='smart cropped (oneshot)', h=h, w=w,
                    sal_hw=sal_dims(w, h, cp['max_input_d']), dest=dest,
                    boxes=boxes, fc=fc, fps=fps,
                    t_read=t_read / len(jobs), t_dev=t_dev / len(jobs)))
            write_boxes_file(txt, np.asarray(boxes, int))
            _eval_inline(annots, vid_fn, ar, boxes)

    # One-deep pipeline: dispatch video k, decode video k+1 while the card
    # runs k, then collect k.
    pending = None
    ars = args.ratios.split(',')
    for i, vid_path in enumerate(vid_paths):
        vid_fn = Path(vid_path).stem
        jobs = []
        for ar in ars:
            suffix = f"{vid_fn}_{ar.replace(':', '-')}"
            txt = results_out / f'{suffix}.txt'
            info_path = results_out / f'{suffix}_info.txt'
            if txt.is_file() and info_path.is_file() and \
                    not args.replace_existing:
                print(f' skipping {suffix}')
                continue
            cp = dict(crop_params)
            cp['out_ratio'] = ar
            jobs.append((ar, cp, txt, info_path))
        if not jobs:
            continue
        print(f'\n video ({i + 1}/{len(vid_paths)}): {vid_path} '
              f'[{",".join(j[0] for j in jobs)}]')
        meta = probe_video(vid_path)
        fps, w, h = meta['fps'], meta['width'], meta['height']
        jobs = [(ar, cp, txt, info_path, calc_dest_size(w, h, ar))
                for ar, cp, txt, info_path in jobs]
        t0 = time.perf_counter()
        reader = open_reader(vid_path)
        try:
            parts = [torch.as_tensor(chunk).to(program.device)
                     for chunk, _ in reader.chunks(256)]
        finally:
            reader.stop()
        raw = torch.cat(parts) if len(parts) > 1 else parts[0]
        t_read = time.perf_counter() - t0
        fc = int(raw.shape[0])
        ticket = None
        t0 = time.perf_counter()
        if fc <= crop_params['read_batch']:
            try:
                ticket = program.dispatch_multi(
                    raw, jobs[0][1], fps=fps,
                    dests=[(d['w_final'], d['h_final'])
                           for _, _, _, _, d in jobs])
            except ValueError as exc:
                print(f' oneshot fallback: {exc}')
        t_disp = time.perf_counter() - t0
        if pending is not None:
            _finish(pending)
        pending = (ticket, vid_path, vid_fn, jobs, meta, fc, t_read, t_disp)
    if pending is not None:
        _finish(pending)


def _sharded_info(cp, clip, dest, boxes, t_spmd, dp) -> dict:
    """Results dict of one ``benchmark --mesh`` clip: the one-shot form of
    :func:`_oneshot_info` over its ``read_video_structure`` dict, the
    batch's wall time shared evenly by its real clips."""
    return _oneshot_info(
        cp, result=f'smart cropped (sharded dp={dp})', h=clip['h_orig'],
        w=clip['w_orig'], sal_hw=clip['sal_frames'].shape[1:3], dest=dest,
        boxes=boxes, fc=clip['fc'], fps=clip['fps'],
        t_read=clip.get('t_ingest', 0.0), t_dev=t_spmd)


def _from_rank0(mesh, obj):
    """Rank 0's ``obj`` on every rank of the mesh."""
    if mesh.group is None:
        return obj
    import torch.distributed as dist
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=mesh.group)
    return box[0]


def _ingest_pipeline(paths, read, depth: int):
    """``read(path)`` for each path in order, two worker threads reading
    ahead by up to ``depth`` paths while the caller consumes."""
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    futures: deque = deque()
    paths = iter(paths)
    with ThreadPoolExecutor(max_workers=2) as ex:

        def topup():
            for p in paths:
                futures.append(ex.submit(read, p))
                if len(futures) >= depth:
                    return

        topup()
        while futures:
            item = futures.popleft().result()
            topup()
            yield item


def cmd_benchmark_sharded(args, vid_paths, results_out, annots, crop_params,
                          mesh):
    """``--mesh N``: every rank ingests every video
    (``read_video_structure``: decode, resizes and shot detection, saliency
    deferred), groups the clips by bucket signature, and runs dp-sized
    groups through :class:`parallel.runner.ShardedClipRunner`, one clip per
    rank.  Rank 0 writes the files and prints the inline IoU."""
    from retargetvid_tpu_torch.eval.annotations import write_boxes_file
    from retargetvid_tpu_torch.ops.boxes import calc_dest_size
    from retargetvid_tpu_torch.parallel.runner import (
        ShardedClipRunner,
        clip_signature,
    )
    from retargetvid_tpu_torch.pipeline.ingest import read_video_structure

    writer = mesh.rank == 0
    dp = mesh.shape['dp']
    if writer:
        print(f' sharded benchmark over mesh {mesh.shape}')
    transnet_fn, un_model = _sharded_models(args)
    runner = ShardedClipRunner(mesh, un_model)
    ars = args.ratios.split(',')

    def ingest_one(vid_path):
        t0 = time.perf_counter()
        clip = read_video_structure(vid_path, crop_params, transnet_fn,
                                    device=args.device)
        clip['vid_fn'] = Path(vid_path).stem
        clip['t_ingest'] = time.perf_counter() - t0
        if writer:
            print(f" ingested: {clip['vid_fn']} ({clip['fc']} frames, "
                  f"{clip['t_ingest']:.2f}s)")
        return clip

    def run_group(batch, n_real):
        c0 = batch[0]
        fps, h_orig, w_orig = c0['fps'], c0['h_orig'], c0['w_orig']
        for ar in ars:
            cp = dict(crop_params)
            cp['out_ratio'] = ar
            dest = calc_dest_size(w_orig, h_orig, ar)
            t0 = time.perf_counter()
            results = runner.run_batch(
                batch, cp, fps=fps, h_orig=h_orig, w_orig=w_orig,
                w_final=dest['w_final'], h_final=dest['h_final'])
            t_per_clip = (time.perf_counter() - t0) / max(n_real, 1)
            if not writer:
                continue
            for c, res in list(zip(batch, results))[:n_real]:
                suffix = f"{c['vid_fn']}_{ar.replace(':', '-')}"
                boxes = np.asarray(res['boxes'], int)
                write_boxes_file(results_out / f'{suffix}.txt', boxes)
                _write_info(results_out / f'{suffix}_info.txt',
                            _sharded_info(cp, c, dest, boxes, t_per_clip,
                                          dp))
                print(f' {suffix}: {len(boxes)} boxes')
                _eval_inline(annots, c['vid_fn'], ar, boxes)

    # Ingest runs ahead on two threads while groups run; a group goes as
    # soon as dp clips of one signature are in.
    pending: dict = {}
    for clip in _ingest_pipeline(vid_paths, ingest_one, max(2, dp + 2)):
        key = (clip['fps'], clip['h_orig'], clip['w_orig'],
               clip_signature(clip))
        pending.setdefault(key, []).append(clip)
        if len(pending[key]) == dp:
            run_group(pending.pop(key), dp)
    # Tail: partial groups, padded by repeating the last clip.
    for rest in pending.values():
        n_real = len(rest)
        run_group(rest + [rest[-1]] * (dp - n_real), n_real)


def cmd_benchmark_oneshot_sharded(args, vid_paths, results_out, annots,
                                  crop_params, mesh):
    """``--mesh N --oneshot``: the whole-clip one-shot program with one
    clip per rank (:class:`parallel.runner.ShardedOneShot`).  Every rank
    decodes every video (two threads read ahead) and groups the clips by
    signature; up to two groups are in flight before the oldest is
    collected.  A clip over ``read_batch`` frames, or one that overruns the
    program's static pick/shot bounds, takes the streaming
    ``smart_vid_crop`` path on rank 0, which alone writes files."""
    from collections import deque

    from retargetvid_tpu_torch.config import sal_dims
    from retargetvid_tpu_torch.eval.annotations import write_boxes_file
    from retargetvid_tpu_torch.io.native_reader import open_reader
    from retargetvid_tpu_torch.io.video import probe_video
    from retargetvid_tpu_torch.ops.boxes import calc_dest_size
    from retargetvid_tpu_torch.parallel.runner import (
        ShardedOneShot,
        raw_clip_signature,
    )

    writer = mesh.rank == 0
    dp = mesh.shape['dp']
    if writer:
        print(f' sharded one-shot benchmark over mesh {mesh.shape}')
    tn_model, un_model = _load_oneshot_models(args)
    runner = ShardedOneShot(
        mesh, tn_model, un_model,
        tn_fullseq=crop_params.get('tpu_transnet_fullseq', False))
    ars = args.ratios.split(',')

    def read_one(vid_path):
        t0 = time.perf_counter()
        meta = probe_video(vid_path)
        reader = open_reader(vid_path)
        try:
            parts = [chunk for chunk, _ in reader.chunks(256)]
        finally:
            reader.stop()
        raw = np.concatenate(parts) if len(parts) > 1 else parts[0]
        return {'raw': raw, 'fps': meta['fps'], 'vid_fn': Path(vid_path).stem,
                'path': vid_path, 't_read': time.perf_counter() - t0}

    fb_models: list = []

    def fallback(item, cp):
        from retargetvid_tpu_torch.pipeline.crop import smart_vid_crop
        if not fb_models:
            fb_models.append(_build_models(args))
        transnet_fn, saliency_fn = fb_models[0]
        vd, res = smart_vid_crop(item['path'], cp, save_vid=False,
                                 transnet_fn=transnet_fn,
                                 saliency_fn=saliency_fn,
                                 device=args.device)
        return np.asarray(vd['bbs'], int), res

    def emit(item, ar, boxes, info):
        suffix = f"{item['vid_fn']}_{ar.replace(':', '-')}"
        write_boxes_file(results_out / f'{suffix}.txt',
                         np.asarray(boxes, int))
        _write_info(results_out / f'{suffix}_info.txt', info)
        print(f' {suffix}: {len(boxes)} boxes')
        _eval_inline(annots, item['vid_fn'], ar, boxes)

    inflight: deque = deque()
    max_groups_inflight = 2

    def collect_group():
        (batch, n_real, ar, cp, dest, ticket, t0, h, w,
         fps) = inflight.popleft()
        results = runner.collect_batch(ticket)
        t_dev = (time.perf_counter() - t0) / max(n_real, 1)
        if not writer:
            return
        for item, res in list(zip(batch, results))[:n_real]:
            if res['overrun']:
                print(f" oneshot overrun, streaming fallback: "
                      f"{item['vid_fn']}")
                emit(item, ar, *fallback(item, cp))
                continue
            emit(item, ar, res['boxes'], _oneshot_info(
                cp, result=f'smart cropped (oneshot dp={dp})', h=h, w=w,
                sal_hw=sal_dims(w, h, cp['max_input_d']), dest=dest,
                boxes=res['boxes'], fc=item['raw'].shape[0], fps=fps,
                t_read=item['t_read'], t_dev=t_dev))

    def run_group(batch, n_real):
        h, w = batch[0]['raw'].shape[1:3]
        fps = batch[0]['fps']
        for ar in ars:
            cp = dict(crop_params)
            cp['out_ratio'] = ar
            dest = calc_dest_size(w, h, ar)
            t0 = time.perf_counter()
            ticket = runner.dispatch_batch(
                [it['raw'] for it in batch], cp, fps=fps,
                w_final=dest['w_final'], h_final=dest['h_final'])
            inflight.append((batch, n_real, ar, cp, dest, ticket, t0,
                             h, w, fps))
            while len(inflight) > max_groups_inflight:
                collect_group()

    def done_paths():
        if args.replace_existing:
            return set()
        done = set()
        for p in vid_paths:
            stem = Path(p).stem
            if all((results_out / f"{stem}_{ar.replace(':', '-')}{s}"
                    ).is_file() for ar in ars for s in ('.txt', '_info.txt')):
                print(f' skipping {stem}')
                done.add(p)
        return done

    # Rank 0 decides what is done, so every rank runs the same groups.
    skip = _from_rank0(mesh, done_paths() if writer else None)
    todo = [p for p in vid_paths if p not in skip]
    pending: dict = {}
    for item in _ingest_pipeline(todo, read_one, max(2, dp + 2)):
        if item['raw'].shape[0] > crop_params['read_batch']:
            if writer:
                print(f" long clip ({item['raw'].shape[0]} frames), "
                      f"streaming fallback: {item['vid_fn']}")
                for ar in ars:
                    cp = dict(crop_params)
                    cp['out_ratio'] = ar
                    emit(item, ar, *fallback(item, cp))
            continue
        key = raw_clip_signature(item['raw'], item['fps'])
        pending.setdefault(key, []).append(item)
        if len(pending[key]) == dp:
            run_group(pending.pop(key), dp)
    for rest in pending.values():
        n_real = len(rest)
        run_group(rest + [rest[-1]] * (dp - n_real), n_real)
    while inflight:
        collect_group()


def _run_on_mesh(args, run):
    """Join the process group named by the ``RTV_*`` variables (when the
    caller has not), build the dp mesh of ``min(--mesh, world size)`` ranks
    on this rank's device, and call ``run(mesh)``; the group this function
    joined is left again on every exit path."""
    import torch.distributed as dist

    from retargetvid_tpu_torch.parallel.distributed import (
        initialize_from_env,
        shutdown,
    )
    from retargetvid_tpu_torch.parallel.mesh import make_mesh

    joined = initialize_from_env(args.device)
    try:
        world = dist.get_world_size() if dist.is_initialized() else 1
        mesh = make_mesh(min(args.mesh, world), device=args.device)
        args.device = mesh.device
        return run(mesh)
    finally:
        if joined:
            shutdown()


def cmd_benchmark(args):
    from retargetvid_tpu_torch.eval.annotations import (
        load_annotations,
        write_boxes_file,
    )
    from retargetvid_tpu_torch.pipeline.crop import smart_vid_crop

    crop_params = sc_init_crop_params(use_best_settings=args.best_settings)
    crop_params['tpu_transnet_fullseq'] = _tn_fullseq(args)

    annots = None
    if args.annotations:
        annots = load_annotations(args.annotations,
                                  extract_to=args.annotations_extract)

    extensions = ('*.AVI', '*.avi', '*.MP4', '*.mp4', '*.MOV', '*.mov')
    vid_paths = sorted(p for ext in extensions
                       for p in glob.glob(os.path.join(args.videos, ext)))
    print(f' Videos:: found {len(vid_paths)} videos in {args.videos}')

    results_out = Path(args.out) / args.test_name
    results_out.mkdir(parents=True, exist_ok=True)

    if args.mesh:
        cmd = (cmd_benchmark_oneshot_sharded if args.oneshot
               else cmd_benchmark_sharded)
        return _run_on_mesh(args, lambda mesh: cmd(
            args, vid_paths, results_out, annots, crop_params, mesh))
    if args.oneshot:
        return cmd_benchmark_oneshot(args, vid_paths, results_out, annots,
                                     crop_params)

    transnet_fn, saliency_fn = _build_models(args)

    for ar in args.ratios.split(','):
        crop_params = dict(crop_params)
        crop_params['out_ratio'] = ar
        for i, vid_path in enumerate(vid_paths):
            vid_fn = Path(vid_path).stem
            suffix = f"{vid_fn}_{ar.replace(':', '-')}"
            txt = results_out / f'{suffix}.txt'
            info = results_out / f'{suffix}_info.txt'
            if txt.is_file() and info.is_file() and not args.replace_existing:
                print(f' skipping {suffix}')
                continue
            print(f'\n video ({i + 1}/{len(vid_paths)}): {vid_path} [{ar}]')
            vd, res = smart_vid_crop(
                vid_path, crop_params,
                final_vid_fn=str(results_out / suffix) if args.save_vid else '',
                temp_path=args.temp_path, save_vid=args.save_vid,
                transnet_fn=transnet_fn, saliency_fn=saliency_fn,
                device=args.device)
            _write_info(info, res)
            write_boxes_file(txt, np.asarray(vd['bbs'], int))
            # Inline eval (reference :2798-2836).
            _eval_inline(annots, vid_fn, ar, vd['bbs'])


def cmd_crop(args):
    from retargetvid_tpu_torch.eval.annotations import write_boxes_file
    from retargetvid_tpu_torch.pipeline.crop import smart_vid_crop

    crop_params = sc_init_crop_params(use_best_settings=args.best_settings)
    crop_params['out_ratio'] = args.ratio
    crop_params['tpu_transnet_fullseq'] = _tn_fullseq(args)
    transnet_fn, saliency_fn = _build_models(args)
    out = Path(args.out or (Path(args.video).stem + '_crop'))
    vd, res = smart_vid_crop(
        args.video, crop_params,
        final_vid_fn=str(out) if args.save_vid else '',
        demo_fn=str(out) + '_demo' if args.demo else '',
        temp_path=args.temp_path, save_vid=args.save_vid,
        transnet_fn=transnet_fn, saliency_fn=saliency_fn,
        copy_sound=args.copy_sound, device=args.device)
    write_boxes_file(str(out) + '.txt', np.asarray(vd['bbs'], int))
    print(res['info'])
    for k, v in res.items():
        if k.startswith('t_'):
            print('  %-22s %s' % (k, v))


def cmd_eval(args):
    from retargetvid_tpu_torch.eval.annotations import load_annotations
    from retargetvid_tpu_torch.eval.harness import evaluate_results_tree

    annots = load_annotations(args.annotations,
                              extract_to=args.annotations_extract)
    evaluate_results_tree(args.results, annots, output_file=args.out)


def cmd_predict(args):
    """Write uint8 PNG saliency maps of a folder of images or a video
    file."""
    import cv2

    from retargetvid_tpu_torch.pipeline.saliency import SaliencyPredictor
    from retargetvid_tpu_torch.train.data import (
        FolderImageDataset,
        FolderVideoDataset,
    )

    predictor = SaliencyPredictor(_load_unisal(args), chunk=args.chunk,
                                  device=args.device)
    path = Path(args.path)
    if path.is_dir():
        ds = FolderImageDataset(path, device=args.device)
        names = [f.stem for f in ds.files]
    else:
        ds = FolderVideoDataset(path, device=args.device)
        names = [f'{i:05d}' for i in range(len(ds.images))]
    out_dir = Path(args.out or (str(path) + '_saliency'))
    out_dir.mkdir(parents=True, exist_ok=True)
    frames = np.stack(ds.images)
    if args.dynamic:
        maps = predictor.predict_video(frames, source=args.source,
                                       smooth_method=args.smooth or None)
    else:
        maps = predictor.predict(frames)
    for name, m in zip(names, maps):
        cv2.imwrite(str(out_dir / f'{name}.png'), m)
    print(f' wrote {len(names)} saliency maps to {out_dir}')


_DATASETS = {}


def _dataset_classes():
    if not _DATASETS:
        from retargetvid_tpu_torch.train.data import (
            DHF1KDataset,
            HollywoodDataset,
            MIT1003Dataset,
            SALICONDataset,
            UCFSportsDataset,
        )
        _DATASETS.update({
            'DHF1K': DHF1KDataset, 'Hollywood': HollywoodDataset,
            'UCFSports': UCFSportsDataset, 'SALICON': SALICONDataset,
            'MIT1003': MIT1003Dataset,
        })
    return _DATASETS


class _SampleLoader:
    """Batch-iterator factory over a dataset's ``sample()`` method."""

    def __init__(self, dataset, n_batches: int, batch_size: int):
        self.dataset = dataset
        self.n_batches = n_batches
        self.batch_size = batch_size

    def __call__(self):
        for _ in range(self.n_batches):
            yield self.dataset.sample(self.batch_size)


class _MITLoader:
    """ImgSizeBatchSampler-backed loader for MIT1003."""

    def __init__(self, dataset, batch_size: int):
        from retargetvid_tpu_torch.train.data import ImgSizeBatchSampler
        self.dataset = dataset
        self.batch_size = batch_size
        self.n_batches = len(ImgSizeBatchSampler(dataset,
                                                 batch_size=batch_size))

    def __call__(self):
        return self.dataset.batches(self.batch_size)


def _build_dataloaders(sources, *, batch_size: int, batches_per_epoch: int,
                       valid_batches: int, seq_len=None, device=None):
    loaders = {}
    for src in sources:
        cls = _dataset_classes()[src]
        if src == 'MIT1003':
            loaders[src] = {
                phase: _MITLoader(cls(phase=phase, device=device), batch_size)
                for phase in ('train', 'valid')}
        else:
            kw = {'device': device}
            if seq_len is not None and src != 'SALICON':
                kw['seq_len'] = seq_len
            loaders[src] = {
                'train': _SampleLoader(cls(phase='train', **kw),
                                       batches_per_epoch, batch_size),
                'valid': _SampleLoader(cls(phase='valid', **kw),
                                       valid_batches, batch_size),
            }
    return loaders


def cmd_train(args):
    """Train UNISAL (reference ``run.py train`` -> ``Trainer.fit``)."""
    import json

    from retargetvid_tpu_torch.train.trainer import Trainer

    sources = tuple(args.sources.split(','))
    model_cfg = json.loads(args.model_cfg) if args.model_cfg else None
    trainer = Trainer(num_epochs=args.num_epochs, lr=args.lr,
                      data_sources=sources,
                      train_cnn_after=args.train_cnn_after,
                      model_cfg=model_cfg, device=args.device)
    loaders = _build_dataloaders(
        sources, batch_size=args.batch_size,
        batches_per_epoch=args.batches_per_epoch,
        valid_batches=args.valid_batches, seq_len=args.seq_len,
        device=args.device)
    best = trainer.fit(loaders, args.train_dir,
                       chkpnt_warmup=args.chkpnt_warmup,
                       chkpnt_epochs=args.chkpnt_epochs)
    print(f'best val score: {best}')
    if args.fine_tune_mit:
        mit = _build_dataloaders(('MIT1003',), batch_size=args.batch_size,
                                 batches_per_epoch=args.batches_per_epoch,
                                 valid_batches=args.valid_batches,
                                 device=args.device)
        best_val, best_epoch = trainer.fine_tune_mit(mit, args.train_dir)
        print(f'MIT1003 fine-tune: best val {best_val} @ epoch {best_epoch}')


def cmd_score(args):
    """Score a trained model (reference ``run.py score_model``).

    The trainer (``model_cfg`` included) is rebuilt from the run's
    ``Trainer.json``, then takes ``weights_best.pkl`` or else the last
    checkpoint; either package's run directory loads.
    """
    from retargetvid_tpu_torch.train.trainer import Trainer

    train_dir = Path(args.train_dir)
    if (train_dir / 'Trainer.json').exists():
        trainer = Trainer.init_from_cfg_dir(train_dir, device=args.device)
    else:
        trainer = Trainer(device=args.device)
    chk = sorted(train_dir.glob('chkpnt_epoch*.pkl'))
    best = train_dir / 'weights_best.pkl'
    if best.exists():
        trainer.init_state()
        trainer.load_weights(best)
        print(f' loaded {best}')
    elif chk:
        trainer.load_chkpnt(chk[-1])
        print(f' loaded {chk[-1]}')
    else:
        raise FileNotFoundError(f'no weights under {train_dir}')
    kw = {'device': args.device}
    if args.seq_len is not None and args.source not in ('SALICON', 'MIT1003'):
        kw['seq_len'] = args.seq_len
    ds = _dataset_classes()[args.source](phase=args.phase, **kw)
    batches = (ds.sample(args.batch_size) for _ in range(args.n_batches))
    scores = trainer.score_model(batches, source=args.source)
    for k, v in scores.items():
        print(f'  {k}: {v:.4f}')
    return scores


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog='retargetvid_tpu_torch',
        description=f'SmartVidCrop (PyTorch) v{smart_crop_version()}')
    sub = p.add_subparsers(dest='cmd', required=True)

    def add_device_arg(sp):
        sp.add_argument('--device', default='cuda',
                        help="torch device to run on ('cuda' needs a GPU; "
                             "'cpu' runs the plain PyTorch versions)")

    def add_model_args(sp):
        sp.add_argument('--unisal-weights', default=os.environ.get(
            'UNISAL_WEIGHTS', ''))
        sp.add_argument('--transnet-weights', default=os.environ.get(
            'TRANSNET_WEIGHTS', ''))
        sp.add_argument('--transnet-arch', choices=('v1', 'v2'),
                        default='v1',
                        help="shot detector: TransNet 'v1' (cut above 0.1; "
                             "weights: the converter's pickle) or 'v2' "
                             '(cut above 0.5; weights: a state dict of the '
                             'published PyTorch module)')
        sp.add_argument('--chunk', type=int, default=32,
                        help='saliency inference batch size')
        sp.add_argument('--best-settings', action='store_true',
                        help='ISM-2021 preset (use_best_settings=True)')
        sp.add_argument('--temp-path', default=None,
                        help='vid_data feature cache directory')
        add_device_arg(sp)

    b = sub.add_parser('benchmark', help='RetargetVid benchmark loop')
    add_model_args(b)
    b.add_argument('--videos', default='DHF1k')
    b.add_argument('--out', default='results')
    b.add_argument('--test-name', default='default_config')
    b.add_argument('--ratios', default='1:3,3:1')
    b.add_argument('--annotations', default=None)
    b.add_argument('--annotations-extract', default=None)
    b.add_argument('--replace-existing', action='store_true')
    b.add_argument('--save-vid', action='store_true')
    b.add_argument('--oneshot', action='store_true',
                   help='one-dispatch whole-clip program per video '
                        '(pipeline.oneshot; falls back to the streaming '
                        'path when a clip exceeds its static bounds)')
    b.add_argument('--mesh', type=int, default=0,
                   help='shard clips over an N-device dp mesh, one process '
                        'per GPU started with RTV_NUM_PROCS/RTV_PROC_ID/'
                        'RTV_COORD (0 = sequential single-device loop)')
    b.add_argument('--tn-plan', choices=('windowed', 'fullseq'),
                   default='fullseq',
                   help="TransNet shot-detection plan.  'fullseq' (the "
                        'benchmark default) runs ONE whole-clip forward: '
                        'the network is fully convolutional in time, so '
                        "this only removes the window plan's edge "
                        'truncation and computes each frame once instead '
                        "of ~2.1x.  'windowed' replicates the reference's "
                        '100/50 sliding-window semantics exactly.')
    b.set_defaults(fn=cmd_benchmark)

    c = sub.add_parser('crop', help='smart-crop one video')
    add_model_args(c)
    c.add_argument('video')
    c.add_argument('--ratio', default='4:5')
    c.add_argument('--out', default=None)
    c.add_argument('--save-vid', action='store_true')
    c.add_argument('--demo', action='store_true')
    c.add_argument('--copy-sound', action='store_true')
    c.add_argument('--tn-plan', choices=('windowed', 'fullseq'),
                   default='windowed',
                   help="TransNet plan; 'crop' keeps the reference's "
                        "windowed semantics by default; pass 'fullseq' for "
                        'the faster whole-clip forward (see benchmark '
                        '--tn-plan)')
    c.set_defaults(fn=cmd_crop)

    e = sub.add_parser('eval', help='standalone results evaluator')
    e.add_argument('results')
    e.add_argument('--annotations', required=True)
    e.add_argument('--annotations-extract', default=None)
    e.add_argument('--out', default='eval_current.txt')
    e.set_defaults(fn=cmd_eval)

    pr = sub.add_parser('predict', help='saliency maps for a folder/video '
                                        '(reference run.py predictions)')
    pr.add_argument('path')
    pr.add_argument('--out', default=None)
    pr.add_argument('--unisal-weights', default=os.environ.get(
        'UNISAL_WEIGHTS', ''))
    pr.add_argument('--chunk', type=int, default=32)
    pr.add_argument('--dynamic', action='store_true',
                    help='recurrent (ConvGRU) video mode with interleaved '
                         'frame-modulo inference (reference run_inference)')
    pr.add_argument('--source', default='DHF1K')
    pr.add_argument('--smooth', default='',
                    help="temporal smoother for --dynamic, e.g. 'med41'")
    add_device_arg(pr)
    pr.set_defaults(fn=cmd_predict)

    t = sub.add_parser('train', help='train UNISAL (reference run.py train)')
    t.add_argument('--train-dir', default=os.environ.get(
        'TRAIN_DIR', 'training_runs/run'))
    t.add_argument('--sources', default='DHF1K,Hollywood,UCFSports,SALICON')
    t.add_argument('--num-epochs', type=int, default=16)
    t.add_argument('--lr', type=float, default=0.04)
    t.add_argument('--batch-size', type=int, default=4)
    t.add_argument('--batches-per-epoch', type=int, default=1000)
    t.add_argument('--valid-batches', type=int, default=100)
    t.add_argument('--train-cnn-after', type=int, default=2)
    t.add_argument('--seq-len', type=int, default=None,
                   help='override dataset sequence length (frames per clip)')
    t.add_argument('--chkpnt-warmup', type=int, default=3)
    t.add_argument('--chkpnt-epochs', type=int, default=2)
    t.add_argument('--fine-tune-mit', action='store_true')
    t.add_argument('--model-cfg', default=None,
                   help='JSON dict of UNISAL constructor overrides '
                        '(persisted in Trainer.json and restored by score)')
    add_device_arg(t)
    t.set_defaults(fn=cmd_train)

    sc = sub.add_parser('score', help='score a trained model '
                                      '(reference run.py score_model)')
    sc.add_argument('--train-dir', required=True)
    sc.add_argument('--source', default='DHF1K')
    sc.add_argument('--phase', default='valid')
    sc.add_argument('--batch-size', type=int, default=4)
    sc.add_argument('--n-batches', type=int, default=25)
    sc.add_argument('--seq-len', type=int, default=None)
    add_device_arg(sc)
    sc.set_defaults(fn=cmd_score)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if hasattr(args, 'device'):
        args.device = resolve_device(args.device)
    return args.fn(args)


if __name__ == '__main__':
    sys.exit(main())
