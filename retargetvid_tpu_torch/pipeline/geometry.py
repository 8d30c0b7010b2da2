"""The geometry chain: saliency volume -> crop boxes.

Port of ``retargetvid_tpu/pipeline/geometry.py:GeometryConfig,
_cut_boundary_fixup, geometry_pipeline`` (reference ``smart_vid_crop``,
``smartVidCrop.py:2296-2522``):

    threshold -> clustering filter (+ cut-boundary map averaging) ->
    center of mass -> empty-center fill -> focus-jump scores + freezing ->
    per-segment interpolation -> Butterworth low-pass -> LOESS/Savitzky-Golay
    -> crop boxes (+ optional time shift)

over padded shapes: frame counts, segment counts and segment lengths are
data, only the bucket sizes are shapes.  The reference's sequential
cut-boundary averaging (frame i's *filtered* map feeds frame i+1's filter
input near shot cuts) is reproduced by recomputing exactly the affected
frames in order, up to the clip's real redo count.  With
``resize_factor != 1`` every filter call, the redo's included, runs on the
factor-downscaled map and is upscaled back.

Only the last step, the crop boxes and their time shift, reads the output
size: multi-ratio serving runs :func:`geometry_series` once and
:func:`geometry_boxes` per ratio.  (The chain syncs with the host for its
loop bounds, so it is not vmapped over ratios as the JAX package does.)
Every crop-parameter setting of the JAX chain is served.

:func:`run_geometry` is the host entry of the streaming path
(``smart_vid_crop``): it pads the ingest's outputs to the bucket sizes and
runs the chain on one device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from retargetvid_tpu_torch.device import resolve_device
from retargetvid_tpu_torch.ops.boxes import compute_crop_boxes, shift_time
from retargetvid_tpu_torch.ops.center import center_of_mass
from retargetvid_tpu_torch.ops.clustering import clustering_filter
from retargetvid_tpu_torch.ops.filters import smooth_segments
from retargetvid_tpu_torch.ops.focus import jump_saliency_scores
from retargetvid_tpu_torch.ops.interpolate import interpolate_segments
from retargetvid_tpu_torch.ops.temporal import (
    fill_empty_centers,
    freeze_unstable_segments,
)
from retargetvid_tpu_torch.ops.threshold import threshold_saliency
from retargetvid_tpu_torch.utils import timing

__all__ = ["GeometryConfig", "geometry_pipeline", "geometry_series",
           "geometry_boxes", "run_geometry", "pad_clip_tables", "bucket_size",
           "seg_bucket_size"]

_BUCKETS = (32, 48, 64, 96, 128, 160, 192, 256, 320, 384, 512, 640, 768,
            1024, 1536, 2048, 3072, 4096, 6144, 8192)


def bucket_size(n: int) -> int:
    for b in _BUCKETS:
        if n <= b:
            return b
    return int(np.ceil(n / 4096) * 4096)


def seg_bucket_size(n: int) -> int:
    """Shot-segment count bucket."""
    for b in (4, 8, 16, 32, 64):
        if n <= b:
            return b
    return bucket_size(n)


@dataclasses.dataclass(frozen=True)
class GeometryConfig:
    """Pipeline parameters, from ``crop_params``."""
    t_threshold: int = 120
    clust_filt: bool = True
    hdbscan_min: int = 26
    select_sum: int = 2
    resize_factor: float = 1.0
    resize_type: int = 1
    op_close: bool = True
    value_bias: float = 1.0
    com_km: bool = True
    focus_stability: bool = False
    foces_stab_t: float = 60.0
    foces_stab_s: float = 1.5
    min_d_jump: float = 10.0
    skip: int = 6
    loess_filt: int = 1
    loess_w_secs: float = 2.0
    loess_degree: int = 2
    lp_filt: int = 1
    lp_cutoff: float = 2.0
    lp_order: int = 5
    shift_time: int = 0
    bridge: int = 1
    cc_iters: int = 12
    adaptive_min_samples: int | None = None
    adaptive_max_radius: int = 4
    #: Replicate the reference ingest's off-by-one (the last selected
    #: frame's saliency map stays zero).
    quirk_batch_tail: bool = True

    @classmethod
    def from_crop_params(cls, cp: dict) -> "GeometryConfig":
        adaptive = None
        if cp.get('tpu_adaptive_link', False) and cp['clust_filt']:
            adaptive = cp.get('hdbscan_min_samples') or cp['hdbscan_min']
        return cls(
            adaptive_min_samples=adaptive,
            quirk_batch_tail=not cp.get('tpu_fix_batch_tail', False),
            t_threshold=cp['t_threshold'],
            clust_filt=cp['clust_filt'],
            hdbscan_min=cp['hdbscan_min'],
            select_sum=cp['select_sum'],
            resize_factor=float(cp['resize_factor']),
            resize_type=cp['resize_type'],
            op_close=cp['op_close'],
            value_bias=float(cp['value_bias']),
            com_km=cp['com_km'],
            focus_stability=cp['focus_stability'],
            foces_stab_t=float(cp['foces_stab_t']),
            foces_stab_s=float(cp['foces_stab_s']),
            min_d_jump=float(cp['min_d_jump']),
            skip=cp['skip'],
            loess_filt=cp['loess_filt'],
            loess_w_secs=float(cp['loess_w_secs']),
            loess_degree=cp['loess_degree'],
            lp_filt=cp['lp_filt'],
            lp_cutoff=float(cp['lp_cutoff']),
            lp_order=cp['lp_order'],
            shift_time=cp['shift_time'],
        )


def _refilter(inp: torch.Tensor, cfg: GeometryConfig) -> torch.Tensor:
    """Clustering filter of (K, H, W) maps at process resolution, the
    ``resize_factor`` roundtrip and the caller-side gates included (pass 1
    and every cut-boundary redo)."""
    return clustering_filter(
        inp, min_cluster_size=cfg.hdbscan_min, select_sum=cfg.select_sum,
        resize_factor=cfg.resize_factor, resize_type=cfg.resize_type,
        op_close=cfg.op_close, bridge=cfg.bridge, cc_iters=cfg.cc_iters,
        min_points=cfg.hdbscan_min + 1,
        adaptive_min_samples=cfg.adaptive_min_samples,
        adaptive_max_radius=cfg.adaptive_max_radius)


def _cut_boundary_fixup(raw: torch.Tensor, pass1: torch.Tensor,
                        cut_mask: torch.Tensor, fc_sel: int,
                        cfg: GeometryConfig, max_cuts: int) -> torch.Tensor:
    """Reproduce the sequential averaging of ``smartVidCrop.py:2369-2373``.

    For each i in order: if i < fc_sel-2 and a cut lies in {i-1, i, i+1},
    frame i+1's filter INPUT becomes the uint8 average of raw frame i+1 and
    frame i's OUTPUT, with the reference's mod-256 wrap of the uint8 sum.
    Only the affected frames are recomputed, in ascending order, up to the
    clip's real redo count.
    """
    t = raw.shape[0]
    dev = raw.device
    idx = torch.arange(t, device=dev)
    false1 = torch.zeros(1, dtype=torch.bool, device=dev)
    prev_cut = torch.cat([false1, cut_mask[:-1]])
    next_cut = torch.cat([cut_mask[1:], false1])
    avg_here = (prev_cut | cut_mask | next_cut) & (idx < fc_sel - 2)
    needs_redo = torch.cat([false1, avg_here[:-1]])
    k_cap = int(min(3 * (max_cuts + 1), t))
    redo = torch.nonzero(needs_redo)[:k_cap, 0].tolist()
    # nonzero waits for its count, tolist for the indices (none to copy
    # when there are none).
    timing.count('dispatch_syncs', 1 + bool(redo))
    timing.count('redo_frames', len(redo))

    acc = pass1.clone()
    prev_idx, prev_out = -2, None
    for jc in redo:
        # Chained redos feed the previous step's output; otherwise the
        # previous frame keeps its pass-1 result.
        prev_map = prev_out if prev_idx == jc - 1 else pass1[max(jc - 1, 0)]
        inp = torch.trunc(torch.remainder(raw[jc] + prev_map, 256.0) / 2.0)
        out = _refilter(inp[None], cfg)[0]
        acc[jc] = out
        prev_idx, prev_out = jc, out
    return acc


def geometry_series(smaps, sel_mask, fc_sel, true_inds,
                    seg_starts, seg_ends, seg_sel_starts, seg_sel_ends,
                    n_segments, *, cfg: GeometryConfig, fps: float,
                    t_out: int) -> dict:
    """Steps 1-7 of the chain, which no output ratio enters: threshold,
    clustering filter and cut-boundary redo, centers, empty-center fill,
    focus stability, per-segment interpolation and smoothing.

    ``smaps`` (T_sel_pad, H, W); ``sel_mask``/``true_inds`` (T_sel_pad,);
    segment arrays (S,); ``fc_sel``/``n_segments`` live counts (ints or
    0-d tensors).  Returns the filtered maps ``sm`` and the series.
    """
    smaps = smaps.to(torch.float32)
    t_sel_pad = smaps.shape[0]
    dev = smaps.device
    # A live count still on the device is read back: one sync each.
    timing.count('dispatch_syncs',
                 torch.is_tensor(fc_sel) + torch.is_tensor(n_segments))
    fc_sel = int(fc_sel)
    n_segments = int(n_segments)

    sm = threshold_saliency(smaps, cfg.t_threshold)

    if cfg.clust_filt:
        with timing.span('geometry.cluster'):
            pass1 = _refilter(sm, cfg)
        # Cut mask over selected frames: live segment starts + last frame.
        live_seg = torch.arange(seg_sel_starts.shape[0], device=dev) \
            < n_segments
        starts = torch.clamp(seg_sel_starts.to(torch.int64), 0,
                             t_sel_pad - 1)
        hits = torch.zeros((t_sel_pad,), dtype=torch.int32, device=dev)
        cut_mask = hits.index_add_(0, starts, live_seg.to(torch.int32)) > 0
        # Setting one element uploads the host's True: one sync.
        cut_mask[min(max(fc_sel - 1, 0), t_sel_pad - 1)] = True
        timing.count('dispatch_syncs')
        with timing.span('geometry.redo'):
            sm = _cut_boundary_fixup(
                sm, pass1, cut_mask, fc_sel, cfg,
                max_cuts=int(seg_sel_starts.shape[0]) + 1)

    cx, cy, valid = center_of_mass(sm, km=cfg.com_km,
                                   factor=cfg.resize_factor)
    valid = valid & sel_mask

    pad_sentinel = -10 ** 6
    live_seg = torch.arange(seg_sel_starts.shape[0], device=dev) < n_segments
    sentinel = torch.full_like(seg_sel_starts, pad_sentinel)
    s_starts = torch.where(live_seg, seg_sel_starts, sentinel)
    s_ends = torch.where(live_seg, seg_sel_ends, sentinel)
    cx, cy = fill_empty_centers(cx, cy, valid, s_starts, s_ends,
                                frame_mask=sel_mask)

    jumps = torch.full((t_sel_pad,), 255.0, dtype=torch.float32, device=dev)
    if cfg.focus_stability:
        # Scores of the moves between consecutive centers over the filtered
        # maps; a low one is a focus jump, and a short span between two
        # jumps is frozen to its first center (smartVidCrop.py:2425-2473).
        jumps = torch.where(sel_mask, jump_saliency_scores(
            sm, cx, cy, min_d_jump=cfg.min_d_jump), jumps)
        is_jump = (jumps < cfg.foces_stab_t) & sel_mask \
            & (torch.arange(t_sel_pad, device=dev) >= 1)
        jump_inds = torch.nonzero(is_jump)[:, 0].tolist()
        timing.count('dispatch_syncs', 1 + bool(jump_inds))
        cx, cy = freeze_unstable_segments(
            cx, cy, jump_inds, fc_sel=fc_sel, skip=cfg.skip, fps=fps,
            stab_secs=cfg.foces_stab_s)

    max_samples, max_len = t_sel_pad, t_out
    with timing.span('geometry.interpolate'):
        dxi = interpolate_segments(cx, true_inds, seg_starts, seg_ends,
                                   seg_sel_starts, seg_sel_ends, n_segments,
                                   t_out, max_samples, max_len)
        dyi = interpolate_segments(cy, true_inds, seg_starts, seg_ends,
                                   seg_sel_starts, seg_sel_ends, n_segments,
                                   t_out, max_samples, max_len)

    dxs, dys, dxl, dyl = smooth_segments(
        dxi, dyi, seg_starts, seg_ends, n_segments,
        fps=fps, loess_filt=cfg.loess_filt, w_secs=cfg.loess_w_secs,
        degree=cfg.loess_degree, lp_filt=cfg.lp_filt,
        lp_cutoff=cfg.lp_cutoff, lp_order=cfg.lp_order, max_len=max_len)

    return {
        'smaps_filtered': torch.clamp(sm, 0, 255).to(torch.uint8),
        'dx': cx, 'dy': cy, 'jumps': jumps,
        'dxi': dxi, 'dyi': dyi, 'dxs': dxs, 'dys': dys,
        'dxl': dxl, 'dyl': dyl,
    }


def geometry_boxes(series: dict, border_t, border_b, border_l, border_r,
                   *, h_orig: int, w_orig: int, h_process: int,
                   w_process: int, w_final, h_final,
                   shift: int = 0) -> dict:
    """Steps 8-9, the only ones an output ratio enters: crop boxes of the
    smoothed series for one (``w_final``, ``h_final``), shifted ``shift``
    frames earlier over the padded (t_out, 4) rows as in JAX (so the last
    ``shift`` rows of a clip shorter than t_out take a padded row's box)."""
    boxes, fbb_w, fbb_h = compute_crop_boxes(
        series['dxs'], series['dys'], w_orig=w_orig, h_orig=h_orig,
        w_process=w_process, h_process=h_process, w_final=w_final,
        h_final=h_final, border_t=border_t, border_b=border_b,
        border_l=border_l, border_r=border_r)
    return {'boxes': shift_time(boxes, shift), 'fbb_w': fbb_w,
            'fbb_h': fbb_h}


def geometry_pipeline(smaps, sel_mask, fc_sel, true_inds,
                      seg_starts, seg_ends, seg_sel_starts, seg_sel_ends,
                      n_segments, fc, border_t, border_b, border_l, border_r,
                      *, cfg: GeometryConfig, fps: float, h_orig: int,
                      w_orig: int, w_final, h_final, t_out: int) -> dict:
    """The geometry chain over padded inputs (see the module docstring):
    :func:`geometry_series` then :func:`geometry_boxes`.  Returns ``boxes``
    (t_out, 4) int32 and the series."""
    del fc                                  # carried for signature parity
    series = geometry_series(
        smaps, sel_mask, fc_sel, true_inds, seg_starts, seg_ends,
        seg_sel_starts, seg_sel_ends, n_segments, cfg=cfg, fps=fps,
        t_out=t_out)
    h, w = smaps.shape[1:]
    return {**geometry_boxes(series, border_t, border_b, border_l, border_r,
                             h_orig=h_orig, w_orig=w_orig, h_process=h,
                             w_process=w, w_final=w_final, h_final=h_final,
                             shift=cfg.shift_time),
            **series}


def pad_clip_tables(true_inds, segmentation, segmentation_sel,
                    seg_bucket: int | None = None):
    """The host tables of a clip padded to the bucket sizes, as numpy
    int64: ``sel_mask`` and ``true_inds`` (T_sel_pad,), the latter
    continued ascending past the picks (interpolation gathers stay
    sane), and the four (S_pad,) segment columns (starts, ends, starts
    and ends over the picks).  Segments pad to ``seg_bucket_size`` or
    to ``seg_bucket`` when given and large enough."""
    t_sel = len(true_inds)
    t_sel_pad = bucket_size(t_sel)
    s = len(segmentation)
    s_pad = seg_bucket_size(s) if seg_bucket is None else (
        seg_bucket if s <= seg_bucket else bucket_size(s))
    sel_mask = np.arange(t_sel_pad) < t_sel
    ti = np.zeros(t_sel_pad, np.int64)
    ti[:t_sel] = np.asarray(true_inds, np.int64)
    if t_sel > 0:
        ti[t_sel:] = ti[t_sel - 1] + np.arange(1, t_sel_pad - t_sel + 1)
    cols = []
    for table in (segmentation, segmentation_sel):
        for col in (0, 1):
            out = np.zeros(s_pad, np.int64)
            out[:s] = np.asarray(table, np.int64)[:, col]
            cols.append(out)
    return sel_mask, ti, cols


def run_geometry(smaps, true_inds, segmentation, segmentation_sel,
                 crop_params: dict, *, fps: float, h_orig: int, w_orig: int,
                 w_final: int, h_final: int, fc: int,
                 borders=(0, 0, 0, 0), seg_bucket: int | None = None,
                 fetch_maps: bool = False, device=None) -> dict:
    """Host entry: pad the ingest outputs to the bucket sizes, run the
    chain on ``device`` (``None`` means the GPU) and return numpy outputs
    trimmed to the clip.

    ``smaps``: (T_sel, H, W) uint8 saliency volume of the selected frames,
    numpy or a tensor (a tensor already on ``device`` is not copied).
    ``fetch_maps`` also returns the filtered volume (the demo render).
    """
    dev = resolve_device(device)
    t_sel = int(smaps.shape[0])
    sel_mask, ti, seg_cols = pad_clip_tables(
        true_inds, segmentation, segmentation_sel, seg_bucket)
    sm = torch.as_tensor(smaps).to(dev)
    if len(ti) != t_sel:
        sm = torch.cat([sm, sm.new_zeros((len(ti) - t_sel,)
                                         + tuple(sm.shape[1:]))])

    def tensor(arr):
        return torch.from_numpy(arr).to(dev)

    with torch.inference_mode():
        out = geometry_pipeline(
            sm, tensor(sel_mask), t_sel, tensor(ti),
            *(tensor(c) for c in seg_cols), len(segmentation), int(fc),
            *(int(b) for b in borders),
            cfg=GeometryConfig.from_crop_params(crop_params),
            fps=float(fps), h_orig=int(h_orig), w_orig=int(w_orig),
            w_final=int(w_final), h_final=int(h_final),
            t_out=bucket_size(fc))
        maps = out.pop('smaps_filtered')
        out = {k: v.cpu().numpy() for k, v in out.items()}
        if fetch_maps:
            out['smaps_filtered'] = maps[:t_sel].cpu().numpy()
    out['boxes'] = out['boxes'][:fc]
    for k in ('dxi', 'dyi', 'dxs', 'dys', 'dxl', 'dyl'):
        out[k] = out[k][:fc]
    for k in ('dx', 'dy', 'jumps'):
        out[k] = out[k][:t_sel]
    return out
