"""Per-clip body: selected frames -> crop boxes, plus output packing.

Port of ``retargetvid_tpu/pipeline/fused.py:make_clip_fn,
pack_clip_outputs, unpack_clip_outputs``: gather of the sampled frames,
Lanczos preprocess, UNISAL static forward, the saliency postprocess
(the hand-written CUDA kernel on the card), the ``sel_mask`` and
reference-quirk zeroing, border detection, mean saliency and the geometry
chain.  One output ratio per call (scalar ``w_final``/``h_final``).
"""

from __future__ import annotations

import contextlib
from typing import Tuple

import numpy as np
import torch

from retargetvid_tpu_torch.kernels.postprocess import saliency_postprocess
from retargetvid_tpu_torch.ops.border import border_detection, mean_saliency
from retargetvid_tpu_torch.pipeline.geometry import (
    GeometryConfig,
    geometry_pipeline,
)
from retargetvid_tpu_torch.pipeline.saliency import preprocess_frames

__all__ = ["make_clip_fn", "pack_clip_outputs", "unpack_clip_outputs"]


def make_clip_fn(model, *, source: str, dtype, t_border: int,
                 cfg: GeometryConfig, in_hw: Tuple[int, int],
                 net_hw: Tuple[int, int], t_out: int, fps: float,
                 h_orig: int, w_orig: int, stage=None):
    """The per-clip body over the clip's device tensors.

    ``dtype`` is the saliency input's dtype (the JAX bench path feeds
    UNISAL bf16).  ``stage(name)``, if given, is a context manager that
    brackets the UNISAL, postprocess and geometry stages (timing).
    """
    if t_border != -1:
        raise NotImplementedError('t_border != -1 is not ported yet')
    stage = stage or (lambda name: contextlib.nullcontext())

    def fn(sal_frames, sel_idx, sel_mask, fc_sel, true_inds,
           seg_starts, seg_ends, seg_sel_starts, seg_sel_ends,
           n_segments, fc, w_final, h_final):
        if np.ndim(w_final) != 0 or np.ndim(h_final) != 0:
            raise NotImplementedError(
                'one output ratio per call (dispatch_multi is not ported)')
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
            out = geometry_pipeline(
                smaps, sel_mask, fc_sel, true_inds,
                seg_starts, seg_ends, seg_sel_starts, seg_sel_ends,
                n_segments, fc,
                borders['border_t'], borders['border_b'],
                borders['border_l'], borders['border_r'],
                cfg=cfg, fps=fps, h_orig=h_orig, w_orig=w_orig,
                w_final=w_final, h_final=h_final, t_out=t_out)
        return {'boxes': out['boxes'], 'mean_sal': mean_sal,
                'dx': out['dx'], 'dy': out['dy'],
                'dxs': out['dxs'], 'dys': out['dys'],
                'dxi': out['dxi'], 'dyi': out['dyi'],
                'jumps': out['jumps'],
                'fbb_w': out['fbb_w'], 'fbb_h': out['fbb_h']}

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
