"""Command-line interface of the PyTorch port.

    python -m retargetvid_tpu_torch.cli {crop,benchmark,eval} ...

Port of ``retargetvid_tpu/cli.py``'s user entry points, which mirror the
reference's:

- ``benchmark``: the ``python smartVidCrop.py`` benchmark loop
  (``smartVidCrop.py:2621-2846``): every video of a directory at the
  requested aspect ratios, ``NNN_<ar>.txt`` + ``NNN_<ar>_info.txt`` per
  video, inline IoU against the 6 annotators; ``--oneshot`` serves each
  video with one ``OneShotClipProgram.dispatch_multi`` for all ratios.
- ``crop``: smart-crop one video (or a reference-format ``.pkl``).
- ``eval``: the standalone ``retargetvid_eval.py`` evaluator.

Model weights: ``--unisal-weights`` (the reference's torch
``weights_best.pth``) and ``--transnet-weights`` (the ``{'params': ...}``
pickle of the TransNet converter); without them the models get seeded
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
    """TransNetV1 from ``--transnet-weights``, else seeded."""
    from retargetvid_tpu_torch.convert import load_flax_variables
    from retargetvid_tpu_torch.models.init import seeded_init_
    from retargetvid_tpu_torch.models.transnet import TransNetV1

    model = TransNetV1()
    if args.transnet_weights:
        with open(args.transnet_weights, 'rb') as fp:
            load_flax_variables(model, pickle.load(fp))
        print(f' loaded TransNet weights from {args.transnet_weights}')
    else:
        seeded_init_(model, 0)
        print(' WARNING: no --transnet-weights; using random init')
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
    from retargetvid_tpu_torch.io.video import open_reader, probe_video
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


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog='retargetvid_tpu_torch',
        description=f'SmartVidCrop (PyTorch) v{smart_crop_version()}')
    sub = p.add_subparsers(dest='cmd', required=True)

    def add_model_args(sp):
        sp.add_argument('--unisal-weights', default=os.environ.get(
            'UNISAL_WEIGHTS', ''))
        sp.add_argument('--transnet-weights', default=os.environ.get(
            'TRANSNET_WEIGHTS', ''))
        sp.add_argument('--chunk', type=int, default=32,
                        help='saliency inference batch size')
        sp.add_argument('--best-settings', action='store_true',
                        help='ISM-2021 preset (use_best_settings=True)')
        sp.add_argument('--temp-path', default=None,
                        help='vid_data feature cache directory')
        sp.add_argument('--device', default='cuda',
                        help="torch device to run on ('cuda' needs a GPU; "
                             "'cpu' runs the plain PyTorch versions)")

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
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if hasattr(args, 'device'):
        args.device = resolve_device(args.device)
    return args.fn(args)


if __name__ == '__main__':
    sys.exit(main())
