"""RetargetVid evaluation harness.

Port of ``retargetvid_tpu/eval/harness.py``, the vectorized form of the
reference evaluator (``retargetvid_eval.py:128-283``) with its scoring
semantics:

- inclusive (+1) rectangle IoU (``retargetvid_eval.py:10-27``);
- negative coordinates of BOTH boxes clamped to 0 (``:181-190``);
- per video: mean of frame IoUs; per user: mean over videos; reported
  worst/best/mean x100 over the 6 users (``:235-246``);
- frame counts taken from annotator 1; extra prediction frames are ignored
  and short files warn and score over the frames present
  (``:174,193-194``);
- a per-run validity report (missing files, frame-count mismatches beyond
  the +-1 tolerance) prints before scoring and never disqualifies a run
  (``:92-125``).

The text it prints and writes is the JAX package's, byte for byte.
"""

from __future__ import annotations

import statistics
from pathlib import Path

import numpy as np

from retargetvid_tpu_torch.eval.annotations import (
    ASPECT_RATIOS,
    VID_INDS,
    frame_counts_from_annots,
    read_boxes_file,
)

__all__ = ["iou_xyxy_inclusive", "iou_series", "benchmark_eval_boxes",
           "validate_runs", "score_run", "parse_info_stats",
           "evaluate_results_tree"]


def iou_xyxy_inclusive(box_a, box_b) -> np.ndarray:
    """Inclusive rectangle IoU, broadcasting over leading dims
    (reference ``retargetvid_eval.py:10-27``, ``smartVidCrop.py:927-944``)."""
    box_a = np.asarray(box_a, dtype=np.float64)
    box_b = np.asarray(box_b, dtype=np.float64)
    xa = np.maximum(box_a[..., 0], box_b[..., 0])
    ya = np.maximum(box_a[..., 1], box_b[..., 1])
    xb = np.minimum(box_a[..., 2], box_b[..., 2])
    yb = np.minimum(box_a[..., 3], box_b[..., 3])
    inter = np.maximum(0.0, xb - xa + 1) * np.maximum(0.0, yb - ya + 1)
    area_a = ((box_a[..., 2] - box_a[..., 0] + 1)
              * (box_a[..., 3] - box_a[..., 1] + 1))
    area_b = ((box_b[..., 2] - box_b[..., 0] + 1)
              * (box_b[..., 3] - box_b[..., 1] + 1))
    return inter / (area_a + area_b - inter)


def iou_series(gt_boxes, pred_boxes) -> np.ndarray:
    """Per-frame IoU with the evaluator's negative-coordinate clamping."""
    gt = np.maximum(np.asarray(gt_boxes, dtype=np.float64), 0.0)
    pr = np.maximum(np.asarray(pred_boxes, dtype=np.float64), 0.0)
    return iou_xyxy_inclusive(gt, pr)


def benchmark_eval_boxes(pred_boxes: np.ndarray, ar: str) -> np.ndarray:
    """The benchmark loop's fixed-size box rewrite before IoU (reference
    ``smartVidCrop.py:2808-2819``): 1:3 keeps x with a 120x360 window, 3:1
    keeps y with a 640x214 window."""
    pred = np.asarray(pred_boxes, dtype=np.int64).copy()
    if ar in ('1:3', '1-3'):
        pred[:, 2] = pred[:, 0] + 120
        pred[:, 3] = 360
    elif ar in ('3:1', '3-1'):
        pred[:, 2] = 640
        pred[:, 3] = pred[:, 1] + 214
    else:
        raise ValueError(f'unknown aspect ratio {ar!r}')
    return pred


def validate_runs(results_dir, annots, vid_inds=VID_INDS,
                  verbose=True) -> dict:
    """Per-run validity report before scoring (``retargetvid_eval.py:92-125``):
    ``{run: (file_errors, frame_count_errors)}``; every run stays eligible
    for scoring, as in the reference."""
    results_dir = Path(results_dir)
    frame_counts = frame_counts_from_annots(annots, vid_inds)
    runs = sorted(p.name for p in results_dir.iterdir() if p.is_dir())
    report = {}
    if verbose:
        print(' Checking runs validity...')
    for run in runs:
        file_errors = 0
        frame_errors = 0
        for vid_ind in vid_inds:
            for ar in ASPECT_RATIOS:
                fn = results_dir / run / ('%03d_%s.txt' % (vid_ind, ar))
                if not fn.is_file():
                    file_errors += 1
                    continue
                with open(fn) as fp:
                    n_lines = len(fp.read().splitlines())
                if abs(frame_counts[vid_ind] - n_lines) > 1:
                    frame_errors += 1
        report[run] = (file_errors, frame_errors)
        if verbose:
            print(' - %-30s (file errors:%d + frame count errors:%d)'
                  % (run, file_errors, frame_errors))
    if verbose:
        print(' valid runs::')
        for run in runs:
            print(' - %s' % run)
    return report


def score_run(run_dir, annots, vid_inds=VID_INDS) -> dict:
    """Score one results directory against all annotators:
    ``{ar: {'worst','best','mean','per_user','per_video','missing_files'}}``
    with scores x100.  Short prediction files warn and score over the
    frames present; an empty file counts as missing."""
    run_dir = Path(run_dir)
    frame_counts = frame_counts_from_annots(annots, vid_inds)
    n_users = len(annots)
    out = {}
    for ar in ASPECT_RATIOS:
        per_user_vid_ious = [[] for _ in range(n_users)]
        per_video = {}
        missing = 0
        for vid_ind in vid_inds:
            fn = run_dir / ('%03d_%s.txt' % (vid_ind, ar))
            if not fn.is_file():
                missing += 1
                continue
            pred = read_boxes_file(fn)
            n_frames = frame_counts[vid_ind]
            if len(pred) < n_frames:
                print('  could not find annotation!  '
                      'run:%s,ar:%s,video:%d,frame:%d'
                      % (run_dir.name, ar, vid_ind, len(pred)))
                n_frames = len(pred)
                if n_frames == 0:
                    missing += 1
                    continue
            pred = np.maximum(pred[:n_frames].astype(np.float64), 0.0)
            gt = np.stack([np.maximum(
                annots[u][ar][vid_ind][:n_frames].astype(np.float64), 0.0)
                for u in range(n_users)])
            ious = iou_xyxy_inclusive(gt, pred[None])   # (users, frames)
            vid_means = ious.mean(axis=1)
            per_video[vid_ind] = vid_means
            for u in range(n_users):
                per_user_vid_ious[u].append(vid_means[u])
        users_ious = [statistics.mean(v) if v else float('nan')
                      for v in per_user_vid_ious]
        out[ar] = {
            'per_user': [x * 100 for x in users_ious],
            'worst': min(users_ious) * 100,
            'best': max(users_ious) * 100,
            'mean': statistics.mean(users_ious) * 100,
            'per_video': per_video,
            'missing_files': missing,
        }
    return out


def parse_info_stats(run_dir, vid_inds=VID_INDS) -> dict:
    """Parse the optional ``NNN_<ar>_info.txt`` stats
    (``retargetvid_eval.py:196-222``): lines holding ``%`` are
    ``<id>: <sec>, <percent>%`` timings; ``cuts_clust``/``cuts_extra``/
    ``no_extra_cuts`` are ints."""
    run_dir = Path(run_dir)
    stats: dict = {}
    for ar in ASPECT_RATIOS:
        stats[ar] = {}
        for vid_ind in vid_inds:
            fn = run_dir / ('%03d_%s_info.txt' % (vid_ind, ar))
            if not fn.is_file():
                continue
            with open(fn) as fp:
                for line in fp.read().splitlines():
                    if '%' in line:
                        key = line.split(':')[0].strip().lower()
                        val = float(line.split(',')[1].replace('%', '')
                                    .strip())
                        stats[ar].setdefault(key, []).append(val)
                    elif 'cuts_clust:' in line:
                        stats[ar].setdefault('cuts_clust', []).append(
                            int(line.split(':')[1].strip()))
                    elif 'cuts_extra:' in line:
                        stats[ar].setdefault('cuts_extra', []).append(
                            int(line.split(':')[1].strip()))
                    elif 'no_extra_cuts:' in line:
                        stats[ar].setdefault('no_extra_cuts', []).append(
                            int(line.split(':')[1].strip()))
    return stats


def _agg(values):
    """(max, mean) with the reference's -1 placeholder when absent."""
    if not values:
        return -1.0, -1.0
    return max(values), statistics.mean(values)


def evaluate_results_tree(results_dir, annots,
                          output_file='eval_current.txt',
                          vid_inds=VID_INDS,
                          verbose=True) -> dict:
    """Evaluate every run directory under ``results_dir``, as
    ``retargetvid_eval.py <results_dir>`` does: the CSV table (Worst/Best/
    Mean IoU per aspect ratio; ttm/tta total time %, tcm/tca clustering
    time, ccm/cca clustering cuts, ecm/eca extra cuts, mf missing files;
    ``:226-283``) printed and written to ``output_file``.  Returns
    ``{run_name: scores}``."""
    results_dir = Path(results_dir)
    runs = sorted(p.name for p in results_dir.iterdir() if p.is_dir())
    validity = validate_runs(results_dir, annots, vid_inds, verbose=verbose)
    if verbose:
        print(' Processing runs...')
    evals = {}
    lines = []
    cols = ('Worst', 'Best', 'Mean', 'ttm', 'tta', 'tcm', 'tca',
            'ccm', 'cca', 'ecm', 'eca')
    header = '%-36s,' % 'Method' + ','.join(
        ['%-6s' % c for c in cols] * 2 + ['%-6s' % 'mf'])
    lines.append(header)
    for i_run, run in enumerate(runs):
        if verbose:
            print(' %3d/%3d: %s ' % (i_run + 1, len(runs), run))
        scores = score_run(results_dir / run, annots, vid_inds)
        stats = parse_info_stats(results_dir / run, vid_inds)
        evals[run] = scores
        evals[run]['info_stats'] = stats
        evals[run]['validity'] = validity.get(run, (0, 0))
        row = '%-36s,' % run
        missing_total = 0
        for ar in ASPECT_RATIOS:
            s = scores[ar]
            st = stats.get(ar, {})
            ttm, tta = _agg(st.get('t_total', []))
            tcm, tca = _agg(st.get('t__clustering',
                                   st.get('t__geometry', [])))
            ccm, cca = _agg(st.get('cuts_clust', []))
            ecm, eca = _agg(st.get('cuts_extra', []))
            row += ('%05.3f,%05.3f,%05.3f,'
                    '%05.3f,%05.3f,%05.3f,%05.3f,'
                    '%05.3f,%05.3f,%05.3f,%05.3f,') % (
                s['worst'], s['best'], s['mean'],
                ttm, tta, tcm, tca, ccm, cca, ecm, eca)
            missing_total += s['missing_files']
        row += '%d' % missing_total
        lines.append(row)
    if verbose:
        for ln in lines:
            print(ln)
    if output_file:
        with open(output_file, 'w') as fp:
            fp.write('\n'.join(lines) + '\n')
    return evals
