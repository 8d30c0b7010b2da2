"""Per-clip body: selected frames -> crop boxes, output packing, and the
two-dispatch path's clip program.

Port of ``retargetvid_tpu/pipeline/fused.py:make_clip_fn,
pack_clip_outputs, unpack_clip_outputs, FusedClipProgram``: gather of the
sampled frames, Lanczos preprocess, UNISAL static forward, the saliency
postprocess (the hand-written CUDA kernel on the card), the ``sel_mask``
and reference-quirk zeroing, border detection, mean saliency and the
geometry chain.  With R output ratios everything up to the smoothed
series runs once and only the crop-box tail runs per ratio.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import numpy as np
import torch

from retargetvid_tpu_torch.device import resolve_device
from retargetvid_tpu_torch.kernels.postprocess import saliency_postprocess
from retargetvid_tpu_torch.ops.border import border_detection, mean_saliency
from retargetvid_tpu_torch.pipeline.geometry import (
    GeometryConfig,
    bucket_size,
    geometry_boxes,
    geometry_series,
    pad_clip_tables,
)
from retargetvid_tpu_torch.pipeline.saliency import (
    get_optimal_out_size,
    preprocess_frames,
)

__all__ = ["make_clip_fn", "pack_clip_outputs", "unpack_clip_outputs",
           "FusedClipProgram", "RATIO_KEYS"]

#: Outputs that carry a leading ratio axis under multi-ratio serving (the
#: keys the JAX package's ``collect_multi`` splits); ``mean_sal`` is shared.
RATIO_KEYS = ('boxes', 'dx', 'dy', 'dxs', 'dys', 'dxi', 'dyi', 'jumps',
              'fbb_w', 'fbb_h')


def make_clip_fn(model, *, source: str, dtype, t_border: int,
                 cfg: GeometryConfig, in_hw: Tuple[int, int],
                 net_hw: Tuple[int, int], t_out: int, fps: float,
                 h_orig: int, w_orig: int, stage=None):
    """The per-clip body over the clip's device tensors.

    ``dtype`` is the saliency input's dtype (the JAX bench path feeds
    UNISAL bf16).  ``w_final``/``h_final`` are ints for one output ratio
    or equal-length sequences for R ratios; then the outputs in
    :data:`RATIO_KEYS` get a leading R axis, as the JAX package's vmapped
    tail gives them.  ``stage(name)``, if given, is a context manager that
    brackets the UNISAL, postprocess and geometry stages (timing).
    """
    stage = stage or (lambda name: contextlib.nullcontext())

    def fn(sal_frames, sel_idx, sel_mask, fc_sel, true_inds,
           seg_starts, seg_ends, seg_sel_starts, seg_sel_ends,
           n_segments, fc, w_final, h_final):
        del fc                              # carried for signature parity
        with stage('unisal'):
            sel = sal_frames[sel_idx]
            x = preprocess_frames(sel, net_hw).to(dtype)
            logp = model(x[:, None], target_size=in_hw, source=source)
        with stage('postprocess'):
            smaps = saliency_postprocess(
                logp[:, 0, :, :, 0].to(torch.float32).contiguous())
        with stage('geometry'):
            smaps = smaps.to(torch.float32)
            smaps = torch.where(sel_mask[:, None, None], smaps,
                                torch.zeros_like(smaps))
            if cfg.quirk_batch_tail:
                # Reference ingest off-by-one: the last selected frame's
                # map stays zero (smartVidCrop.py:409-421).
                t_idx = torch.arange(smaps.shape[0], device=smaps.device)
                smaps = torch.where((t_idx == fc_sel - 1)[:, None, None],
                                    torch.zeros_like(smaps), smaps)
            borders = border_detection(smaps, t_border, h_orig, w_orig)
            mean_sal, _ = mean_saliency(smaps)
            series = geometry_series(
                smaps, sel_mask, fc_sel, true_inds,
                seg_starts, seg_ends, seg_sel_starts, seg_sel_ends,
                n_segments, cfg=cfg, fps=fps, t_out=t_out)

            def tail(wf, hf):
                return geometry_boxes(
                    series, borders['border_t'], borders['border_b'],
                    borders['border_l'], borders['border_r'],
                    h_orig=h_orig, w_orig=w_orig, h_process=in_hw[0],
                    w_process=in_hw[1], w_final=wf, h_final=hf,
                    shift=cfg.shift_time)

            if np.ndim(w_final) == 0:
                out = {**series, **tail(w_final, h_final)}
            else:
                tails = [tail(int(wf), int(hf))
                         for wf, hf in zip(w_final, h_final)]
                out = {k: torch.stack([t[k] for t in tails])
                       for k in tails[0]}
                for k in RATIO_KEYS:
                    if k not in out:
                        out[k] = series[k].expand(len(tails),
                                                  *series[k].shape)
        return {**{k: out[k] for k in RATIO_KEYS}, 'mean_sal': mean_sal}

    return fn


def pack_clip_outputs(out: dict):
    """Flatten the output dict into ONE float32 vector (one device-to-host
    copy).  Box coordinates are < 2**24, so the float32 round trip is
    exact.  Returns (vector, spec) with spec key -> (offset, shape)."""
    spec = {}
    parts = []
    off = 0
    canonical = ('boxes', 'dx', 'dy', 'dxs', 'dys', 'dxi', 'dyi', 'jumps',
                 'mean_sal', 'fbb_w', 'fbb_h')
    keys = [k for k in canonical if k in out] + \
        [k for k in out if k not in canonical]
    for k in keys:
        v = torch.as_tensor(out[k])
        spec[k] = (off, tuple(v.shape))
        parts.append(v.to(torch.float32).reshape(-1))
        off += v.numel()
    return torch.cat(parts), spec


def unpack_clip_outputs(vec: np.ndarray, spec: dict) -> dict:
    out = {}
    for k, (off, shape) in spec.items():
        n = int(np.prod(shape)) if shape else 1
        v = vec[off:off + n].reshape(shape)
        out[k] = v.astype(np.int32) if k == 'boxes' else v
    return out


class FusedClipProgram:
    """The two-dispatch path's clip program: device-resident saliency
    frames plus the host's sampling and scenes -> crop boxes.

    Serves clips the one-shot program refuses (more shots than its
    ``s_pad``).  ``un_model`` is a ``UNISAL`` module; ``dtype`` its input's
    dtype.  ``device=None`` means the GPU.  Shapes are padded as in the
    JAX package: the picks to ``bucket_size``, the frames to
    ``bucket_size(fc)``, the segments to ``seg_bucket_size`` (or
    ``seg_bucket``), with ``true_inds`` continued ascending past the picks.
    """

    def __init__(self, un_model, source: str = 'SALICON',
                 dtype=torch.bfloat16, t_border: int = -1, device=None):
        self.device = resolve_device(device)
        self.un_model = un_model.to(self.device).eval()
        self.source = source
        self.dtype = dtype
        self.t_border = t_border
        #: Optional ``pipeline.oneshot.StageTimer`` (CUDA devices only).
        self.timer = None

    def run(self, sal_frames, selected, true_inds, segmentation,
            segmentation_sel, crop_params: dict, *, fps: float,
            h_orig: int, w_orig: int, w_final: int, h_final: int,
            fc: int, seg_bucket: Optional[int] = None) -> dict:
        """(T_all, H, W, 3) uint8 saliency frames -> outputs dict (numpy).

        ``selected``: indices of the sampled frames into ``sal_frames``;
        ``true_inds`` their frame numbers; ``segmentation`` /
        ``segmentation_sel`` the (S, 2) scene tables over frames and over
        picks (``ops.scenes``).
        """
        cfg = GeometryConfig.from_crop_params(crop_params)
        t_sel = len(selected)
        t_out = bucket_size(fc)
        sal = torch.as_tensor(sal_frames).to(self.device)
        h, w = int(sal.shape[1]), int(sal.shape[2])
        sel_mask, ti, seg_cols = pad_clip_tables(
            true_inds, segmentation, segmentation_sel, seg_bucket)
        sel_idx = np.zeros(len(ti), np.int64)
        sel_idx[:t_sel] = np.asarray(selected, np.int64)

        def dev(arr):
            return torch.from_numpy(arr).to(self.device)

        stage = self.timer.stage if self.timer is not None else None
        clip_fn = make_clip_fn(
            self.un_model, source=self.source, dtype=self.dtype,
            t_border=self.t_border, cfg=cfg, in_hw=(h, w),
            net_hw=get_optimal_out_size((h, w)), t_out=t_out,
            fps=float(fps), h_orig=int(h_orig), w_orig=int(w_orig),
            stage=stage)
        with torch.inference_mode():
            vec, spec = pack_clip_outputs(clip_fn(
                sal, dev(sel_idx), dev(sel_mask), t_sel, dev(ti),
                *(dev(c) for c in seg_cols), len(segmentation), int(fc),
                int(w_final), int(h_final)))
        # One device-to-host copy for all outputs.
        out = unpack_clip_outputs(vec.cpu().numpy(), spec)
        out['boxes'] = out['boxes'][:fc]
        for k in ('dxi', 'dyi', 'dxs', 'dys'):
            out[k] = out[k][:fc]
        for k in ('dx', 'dy', 'jumps'):
            out[k] = out[k][:t_sel]
        return out
