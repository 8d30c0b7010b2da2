"""The single-video orchestrator: ``smart_vid_crop``.

Port of ``retargetvid_tpu/pipeline/crop.py`` (reference entry point
``smartVidCrop.py:2218-2614``): ingest (video, reference ``.pkl`` or the
feature cache) -> destination size -> border detection -> pad gates ->
the geometry chain (``pipeline.geometry.run_geometry``) -> optional
rendering -> the results dict with the reference's info/params/scores/
times string contracts.  Host glue: stage timing, gating, file IO.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from retargetvid_tpu_torch.config import sc_init_crop_params
from retargetvid_tpu_torch.device import resolve_device
from retargetvid_tpu_torch.ops.border import (
    border_detection,
    coverage_score,
    mean_saliency,
)
from retargetvid_tpu_torch.ops.boxes import calc_dest_size
from retargetvid_tpu_torch.pipeline.geometry import run_geometry
from retargetvid_tpu_torch.pipeline.ingest import (
    ingest_pickle,
    load_vid_data,
    read_and_segment_video,
    save_vid_data,
)
from retargetvid_tpu_torch.utils.timing import (
    sc_all_times,
    sc_init_time,
    sc_register_time,
    sc_save_time_override,
    sc_times,
)

__all__ = ["smart_vid_crop"]


def smart_vid_crop(video_path, CP: Optional[dict] = None,
                   demo_fn: str = '', final_vid_fn: str = '',
                   plots_fn: str = '', frames_dir: str = '',
                   temp_path: Optional[str] = None,
                   verbose: bool = False, save_vid: bool = True,
                   transnet_fn: Optional[Callable] = None,
                   saliency_fn: Optional[Callable] = None,
                   vid_data: Optional[dict] = None,
                   copy_sound: bool = False,
                   callback_progress: Optional[Callable] = None,
                   callback_session=None,
                   callback_status: Optional[Callable] = None,
                   device=None):
    """Smart-crop one video; returns ``(vid_data, results_dict)``.

    The reference's signature plus injection points: ``transnet_fn`` /
    ``saliency_fn`` supply the model forwards, and ``vid_data``
    short-circuits ingest (the reference's feature-cache path,
    ``smartVidCrop.py:2244-2256``).  ``callback_progress/_session/_status``
    reproduce the web-service progress protocol (``:2258-2531``).
    ``device`` is where the ingest and geometry run (``None`` means the
    GPU; the model forwards run where their own objects were placed).
    """
    del frames_dir                          # accepted for signature parity
    dev = resolve_device(device)

    def _status(code, label):
        if callback_status is not None and callback_session is not None:
            callback_status(callback_session, 'sc', code, label)

    def _progress(vd_local, stage):
        if callback_progress is not None and callback_session is not None:
            dur = vd_local['fc'] / vd_local['fr'] if vd_local['fr'] else 0.0
            callback_progress(callback_session, dur * 0.12, stage)
    sc_init_time()
    results: dict = {}
    do_pad = False

    if CP is None:
        CP = sc_init_crop_params()

    # Feature cache probe (reference :2244-2256).
    vd = vid_data
    cache_file = None
    if vd is None and temp_path is not None:
        stem = Path(str(video_path)).stem
        cache_file = Path(temp_path) / f'{stem}.pkl'
        if cache_file.is_file():
            vd = load_vid_data(cache_file)
            for k, v in vd.get('times', {}).items():
                sc_save_time_override(k, v)

    _status('SC VIDEO ANALYSIS', 'smart-cropping video analysis')
    if vd is None:
        if str(video_path).endswith('.pkl'):
            if saliency_fn is None:
                raise ValueError('saliency_fn required for pickle ingest')
            vd = ingest_pickle(video_path, CP, saliency_fn, verbose=verbose,
                               device=dev)
        else:
            if transnet_fn is None or saliency_fn is None:
                raise ValueError(
                    'transnet_fn and saliency_fn are required to ingest '
                    'video (pass model forwards or a cached vid_data)')
            vd = read_and_segment_video(video_path, CP, transnet_fn,
                                        saliency_fn, verbose=verbose,
                                        device=dev)
        if cache_file is not None and not cache_file.is_file():
            vd['times'] = sc_times()
            cache_file.parent.mkdir(parents=True, exist_ok=True)
            save_vid_data(cache_file, vd)

    _progress(vd, 'STAGE#1')
    _status('SC PROCESSING', 'smart-cropping main process')
    _progress(vd, 'STAGE#2')
    smaps = torch.as_tensor(vd['smaps']).to(dev)          # (T, H, W) uint8

    # Destination size (reference :2298).
    t = time.perf_counter()
    dest = calc_dest_size(vd['w_orig'], vd['h_orig'], CP['out_ratio'])
    vd.update(dest)
    sc_register_time(t, '_calc_dest_size')

    # Border detection (reference :2304).
    t = time.perf_counter()
    borders = border_detection(smaps, CP['t_border'],
                               vd['h_orig'], vd['w_orig'])
    borders = tuple(int(borders[k]) for k in
                    ('border_t', 'border_b', 'border_l', 'border_r'))
    vd['border_t'], vd['border_b'], vd['border_l'], vd['border_r'] = borders
    sc_register_time(t, '_border_det')

    # Pad gate #1: spread saliency (reference :2310-2321).
    t = time.perf_counter()
    if CP['exit_on_spread_sal']:
        mean_sal, _ = mean_saliency(smaps)
        vd['mean_sal_score'] = float(mean_sal)
        if vd['mean_sal_score'] > CP['t_sal']:
            do_pad = True
    else:
        vd['mean_sal_score'] = None
    sc_register_time(t, '_check_mean_sal')

    # Pad gate #2: coverage (reference :2380-2393; quirk preserved -- the
    # reference's full-width window always scores 0.0).
    t = time.perf_counter()
    if not do_pad and CP['exit_on_low_cvrg']:
        cvrg, _ = coverage_score(smaps, vd['conversion_mode'])
        vd['mean_cvrg_score'] = float(cvrg)
        if vd['mean_cvrg_score'] < CP['t_cvrg']:
            do_pad = True
    else:
        vd['mean_cvrg_score'] = None
    sc_register_time(t, '_check_cvrg')

    if not do_pad:
        # The geometry chain, threshold through crop boxes; its wall time
        # goes under the reference's ``_clustering`` key (its dominant
        # stage, smartVidCrop.py:2375) so the evaluator's tcm/tca columns
        # read it.
        t = time.perf_counter()
        geo = run_geometry(
            smaps, vd['true_inds'], vd['segmentation'],
            vd['segmentation_sel'], CP,
            fps=vd['fr'], h_orig=vd['h_orig'], w_orig=vd['w_orig'],
            w_final=vd['w_final'], h_final=vd['h_final'], fc=vd['fc'],
            borders=borders, fetch_maps=bool(demo_fn), device=dev)
        sc_register_time(t, '_clustering')
        vd['bbs'] = geo['boxes'].tolist()
        vd['fbb_w'] = int(geo['fbb_w'])
        vd['fbb_h'] = int(geo['fbb_h'])
        for k in ('dx', 'dy', 'dxi', 'dyi', 'dxs', 'dys', 'jumps'):
            vd[k] = geo[k].tolist()
        vd['geometry'] = geo
    else:
        vd['fbb_w'] = vd['w_final']
        vd['fbb_h'] = vd['h_final']
        vd['bbs'] = []

    # Debug plots (reference sc_plot_signals / debug_preview, :2490-2506).
    if plots_fn and not do_pad:
        from retargetvid_tpu_torch.utils.plots import (
            plot_signals,
            plot_smoothing_preview,
        )
        plot_signals(vd, plots_fn.replace('.png', '_signals.png'))
        plot_smoothing_preview(vd, plots_fn)

    # Rendering (optional; reference :2536-2553).
    _status('SC RENDERING', 'smart-cropping rendering')
    _progress(vd, 'STAGE#3')
    t = time.perf_counter()
    if save_vid and str(video_path).endswith('.pkl') and not do_pad:
        # Web-service mode: cropped frames go back out as <stem>_sc.pkl.
        from retargetvid_tpu_torch.pipeline.render import (
            render_cropped_pickle,
        )
        render_cropped_pickle(video_path, np.asarray(vd['bbs']))
        results['result'] = 'smart cropped'
    elif save_vid and not str(video_path).endswith('.pkl'):
        from retargetvid_tpu_torch.pipeline import render as render_mod
        if do_pad:
            if final_vid_fn:
                render_mod.render_padded(video_path, final_vid_fn + '.mp4',
                                         vd['w_final'], vd['h_final'])
            results['result'] = 'padded'
        else:
            if final_vid_fn:
                render_mod.render_cropped(video_path, np.asarray(vd['bbs']),
                                          final_vid_fn + '.mp4')
            if demo_fn:
                render_mod.render_demo(video_path, vd, vd['geometry'],
                                       demo_fn + '.mp4')
            results['result'] = 'smart cropped'
    else:
        results['result'] = 'padded' if do_pad else 'smart cropped'
    sc_register_time(t, 'render')

    if save_vid and copy_sound and final_vid_fn:
        t = time.perf_counter()
        from retargetvid_tpu_torch.io.video import mux_audio
        mux_audio(final_vid_fn + '.mp4', video_path)
        sc_register_time(t, 'copy_sound')

    # Results dict with the reference's string contracts (:2581-2610).
    results['info'] = ' (%dx%d)->(%dx%d)->(%dx%d)->(%dx%d)\n' % (
        vd['h_orig'], vd['w_orig'], vd['h_process'], vd['w_process'],
        vd['h_final'], vd['w_final'], vd['fbb_h'], vd['fbb_w'])
    results['params'] = ''.join(
        ' %-18s : %s\n' % (k, str(v)) for k, v in CP.items())
    results['mean_sal_score'] = vd['mean_sal_score']
    results['mean_sal_score_t'] = CP['t_sal']
    results['coverage_score'] = vd['mean_cvrg_score']
    results['coverage_score_t'] = CP['t_cvrg']
    # The reference's ``total_clust_cuts`` list is never appended to, so
    # its ``cuts_clust`` is 0 for every video (smartVidCrop.py:2352, 2374).
    results['cuts_clust'] = 0

    t_dict = sc_all_times(vd['fc'] / vd['fr'] if vd['fr'] else 1.0)
    for k in t_dict:
        results['t_' + k] = t_dict[k]

    return vd, results
