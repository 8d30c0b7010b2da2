"""Whole-clip program: raw frames -> crop boxes.

Port of ``retargetvid_tpu/pipeline/oneshot.py:sample_frames_device,
scene_bounds_device, make_oneshot_body, OneShotClipProgram``:

1. two linear ingest resizes (27x48 for TransNet, max-dim 250 for
   saliency), quantized to uint8;
2. TransNetV1: the reference's 100/50 window plan (the default, as in the
   JAX package) or one forward over the edge-padded clip
   (``tn_fullseq=True``, the JAX bench and ``cli benchmark`` default);
3. frame sampling and scene bounds on the device;
4. UNISAL on the sampled frames, the saliency postprocess kernel and the
   geometry chain (``pipeline.fused``), for one output ratio
   (:meth:`OneShotClipProgram.run`) or R of them from one pass
   (:meth:`OneShotClipProgram.dispatch_multi`).

A clip with more shots than ``s_pad`` is refused; the two-dispatch path
(``models.transnet.IngestShotProgram`` or ``TransNetPredictor``, host
sampling and scenes, ``pipeline.fused.FusedClipProgram``) serves it.  The
dynamic (ConvGRU) saliency branch is not ported yet.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch

from retargetvid_tpu_torch.config import TRANS_THRESHOLD, sal_dims
from retargetvid_tpu_torch.device import resolve_device
from retargetvid_tpu_torch.models.transnet import (
    fullseq_forward,
    window_forward,
)
from retargetvid_tpu_torch.pipeline.fused import (
    RATIO_KEYS,
    make_clip_fn,
    pack_clip_outputs,
    unpack_clip_outputs,
)
from retargetvid_tpu_torch.pipeline.ingest import _resize_kernel
from retargetvid_tpu_torch.pipeline.geometry import GeometryConfig, bucket_size
from retargetvid_tpu_torch.pipeline.saliency import get_optimal_out_size

__all__ = ["OneShotClipProgram", "StageTimer", "sample_frames_device",
           "scene_bounds_device", "make_oneshot_body"]


def _first_true(mask: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """``jnp.nonzero(mask, size=size, fill_value=fill)[0]`` without a host
    sync: the ascending indices of the True entries, padded with ``fill``."""
    n = mask.shape[0]
    idx = torch.arange(n, device=mask.device)
    keyed = torch.where(mask, idx, torch.full_like(idx, n))
    out = torch.sort(keyed).values[:size]
    if out.shape[0] < size:
        out = torch.cat([out, torch.full((size - out.shape[0],), n,
                                         dtype=out.dtype, device=out.device)])
    return torch.where(out >= n, torch.full_like(out, fill), out)


def sample_frames_device(probs: torch.Tensor, skip: int, fc: int,
                         t_sel_pad: int, threshold: float = TRANS_THRESHOLD,
                         n: Optional[int] = None):
    """The reference's frame-selection rule (``smartVidCrop.py:379-399``).

    Sequentially: select frame f when it is ``skip`` after the last
    selected frame, follows a frame whose transition probability exceeds
    ``threshold``, or is the final live frame.  The chain restarts at
    frame 0 and after every cut, so the picks are the frames a multiple of
    ``skip`` past their latest anchor (frame 0 or a post-cut frame), plus
    the final frame -- computed here in closed form.

    ``fc`` is the capacity, ``n`` (default ``fc``) the live frame count.
    Returns (sel_mask (fc,), sel_idx (t_sel_pad,), fc_sel, ti
    (t_sel_pad,)); ``ti`` continues ascending past the live picks.
    """
    dev = probs.device
    n = fc if n is None else int(n)
    fidx = torch.arange(fc, device=dev)
    after_cut = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev),
                           probs[:fc - 1] > threshold])
    anchor = (fidx == 0) | after_cut
    last_anchor = torch.cummax(torch.where(anchor, fidx,
                                           torch.full_like(fidx, -1)),
                               0).values
    sel_mask = ((((fidx - last_anchor) % skip) == 0) | (fidx == n - 1)) \
        & (fidx < n)
    fc_sel = sel_mask.sum()
    sel_idx = _first_true(sel_mask, t_sel_pad, fc - 1)
    sel_idx = torch.clamp(sel_idx, max=max(n - 1, 0))
    k = torch.arange(t_sel_pad, device=dev)
    last_ti = sel_idx[torch.clamp(fc_sel - 1, 0, t_sel_pad - 1)]
    ti = torch.where(k < fc_sel, sel_idx, last_ti + (k - fc_sel + 1))
    return sel_mask, sel_idx, fc_sel, ti


def scene_bounds_device(probs: torch.Tensor, sel_mask: torch.Tensor,
                        fc: int, s_pad: int,
                        threshold: float = TRANS_THRESHOLD,
                        n: Optional[int] = None):
    """Post-boundary-fix segmentation as padded (s_pad,) arrays.

    A scene starts at each below-threshold frame at position 0 or after an
    above-threshold frame; with no below-threshold frame at all the clip is
    one scene.  Returns (seg_starts, seg_ends, seg_sel_starts,
    seg_sel_ends, n_segments).
    """
    dev = probs.device
    n_live = fc if n is None else int(n)
    fidx = torch.arange(fc, device=dev)
    live = fidx < n_live
    p = (probs[:fc] > threshold) & live
    prev_hi = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev),
                         p[:-1]])
    is_start = (~p) & ((fidx == 0) | prev_hi) & live
    n_seg = is_start.sum()
    starts = _first_true(is_start, s_pad, fc)
    k = torch.arange(s_pad, device=dev)
    fallback = torch.where(k == 0, torch.zeros_like(k),
                           torch.full_like(k, fc))
    starts = torch.where(n_seg == 0, fallback, starts)
    n_seg = torch.clamp(n_seg, min=1)
    next_start = torch.cat([starts[1:], torch.full((1,), fc, dtype=starts.dtype,
                                                   device=dev)])
    ends = torch.where(k == n_seg - 1, torch.full_like(k, n_live - 1),
                       next_start - 1)
    m2o = torch.cumsum(sel_mask.to(torch.int64), 0) - 1

    def safe(idx):
        return m2o[torch.clamp(idx, 0, fc - 1)]

    return starts, ends, safe(starts), safe(ends), n_seg


class StageTimer:
    """CUDA-event timing of the program's stages (``transnet``, ``unisal``,
    ``postprocess``, ``geometry``).  Assign one to
    ``OneShotClipProgram.timer``; read :meth:`times_ms` after the run."""

    def __init__(self):
        self.events = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        yield
        end.record()
        self.events.setdefault(name, []).append((start, end))

    def times_ms(self) -> dict:
        torch.cuda.synchronize()
        return {k: [s.elapsed_time(e) for s, e in v]
                for k, v in self.events.items()}


def make_oneshot_body(un_model, tn_model, *, source, dtype, t_border,
                      cfg: GeometryConfig, fc: int, sal_hw, net_hw,
                      t_out: int, t_sel_pad: int, s_pad: int, skip: int,
                      fps: float, h_orig: int, w_orig: int,
                      window: int = 100, stride: int = 50,
                      keep: tuple = (25, 75), tn_fullseq: bool = False,
                      stage=None):
    """Whole-clip body ``(raw, w_final, h_final, n=None) -> dict``; the
    targets are ints for one ratio or equal-length sequences for R ratios.

    ``fc`` is the frame capacity; ``n`` (default ``fc``) the clip's live
    frame count, with ``raw`` padded by zero frames up to ``fc``: shot
    detection reads the first ``n`` frames, the probabilities past ``n``
    are 0 and sampling and scenes stop at ``n``.  Shared by
    :class:`OneShotClipProgram` (``n == fc``) and
    ``parallel.runner.ShardedOneShot``, which pads the clips of a batch to
    one capacity."""
    stage = stage or (lambda name: contextlib.nullcontext())
    sal_h, sal_w = sal_hw
    clip_fn = make_clip_fn(
        un_model, source=source, dtype=dtype, t_border=t_border, cfg=cfg,
        in_hw=(sal_h, sal_w), net_hw=net_hw, t_out=t_out, fps=fps,
        h_orig=h_orig, w_orig=w_orig, stage=stage)
    resize = _resize_kernel(h_orig, w_orig, sal_h, sal_w)

    def body(raw, w_final, h_final, n=None):
        dev = raw.device
        n = fc if n is None else int(n)
        with stage('transnet'):
            tn, sal = resize(raw)
            if tn_fullseq:
                probs = fullseq_forward(tn_model, tn, n, fc, keep=keep)
            else:
                probs = window_forward(tn_model, tn, n, fc, window=window,
                                       stride=stride, keep=keep)
            if n < fc:
                probs = torch.where(torch.arange(fc, device=dev) < n,
                                    probs, torch.zeros_like(probs))
            sel_mask_f, sel_idx, fc_sel, ti = sample_frames_device(
                probs, skip, fc, t_sel_pad, n=n)
            ss, se, sss, sse, n_seg = scene_bounds_device(
                probs, sel_mask_f, fc, s_pad, n=n)
        # Clamp against a clip with more picks than t_sel_pad, as XLA
        # clamps its gathers: the body completes, and the caller sees the
        # raw counts (collect() raises, ShardedOneShot flags an overrun).
        fc_sel_c = torch.clamp(fc_sel, max=t_sel_pad)
        sel_live = torch.arange(t_sel_pad, device=dev) < fc_sel_c
        sss_c, sse_c = (torch.clamp(v, max=t_sel_pad - 1) for v in (sss, sse))
        out = clip_fn(sal, sel_idx, sel_live, fc_sel_c, ti, ss, se, sss_c,
                      sse_c, n_seg, n, w_final, h_final)
        out['probs'] = probs
        out['fc_sel'] = fc_sel
        out['n_segments'] = n_seg
        out['seg_starts'] = ss
        out['seg_ends'] = se
        out['sel_idx'] = sel_idx
        return out

    return body


class OneShotClipProgram:
    """Raw decoded frames -> crop boxes on one device.

    ``tn_model``/``un_model``: ``TransNetV1`` and ``UNISAL`` modules (for
    example filled by ``convert.load_flax_variables``).  TransNet computes
    in ``dtype``; UNISAL takes its input in ``dtype`` and computes in its
    own parameters' dtype (float32), as the JAX models do.  The TransNet
    plan is the 100/50 window plan (``window``, ``stride``, ``keep``)
    unless ``tn_fullseq``.  ``device=None`` means the GPU.
    """

    def __init__(self, tn_model, un_model, source: str = 'SALICON',
                 dtype=torch.bfloat16, t_border: int = -1, s_pad: int = 8,
                 window: int = 100, stride: int = 50,
                 keep: tuple = (25, 75), tn_fullseq: bool = False,
                 device=None):
        if window % stride:
            raise ValueError('window must be a multiple of stride')
        self.device = resolve_device(device)
        self.tn_model = tn_model.to(self.device, dtype).eval()
        self.un_model = un_model.to(self.device).eval()
        self.source = source
        self.dtype = dtype
        self.t_border = t_border
        self.s_pad = s_pad
        self.window = window
        self.stride = stride
        self.keep = keep
        self.tn_fullseq = tn_fullseq
        #: Optional :class:`StageTimer` (CUDA devices only).
        self.timer: Optional[StageTimer] = None

    def _t_sel_pad(self, fc: int, skip: int) -> int:
        return bucket_size(fc // skip + 2 + self.s_pad)

    def _dispatch(self, raw_frames, crop_params: dict, fps: float,
                  w_final, h_final):
        raw = torch.as_tensor(raw_frames).to(self.device)
        if raw.dtype != torch.uint8 or raw.ndim != 4 or raw.shape[-1] != 3:
            raise ValueError(f'raw frames must be (fc, H, W, 3) uint8, got '
                             f'{tuple(raw.shape)} {raw.dtype}')
        fc, h, w = int(raw.shape[0]), int(raw.shape[1]), int(raw.shape[2])
        sal_hw = sal_dims(w, h, crop_params['max_input_d'])
        cfg = GeometryConfig.from_crop_params(crop_params)
        skip = int(crop_params['skip'])
        stage = self.timer.stage if self.timer is not None else None
        body = make_oneshot_body(
            self.un_model, self.tn_model, source=self.source,
            dtype=self.dtype, t_border=self.t_border, cfg=cfg, fc=fc,
            sal_hw=sal_hw, net_hw=get_optimal_out_size(sal_hw),
            t_out=bucket_size(fc), t_sel_pad=self._t_sel_pad(fc, skip),
            s_pad=self.s_pad, skip=skip, fps=float(fps), h_orig=h,
            w_orig=w, window=self.window, stride=self.stride,
            keep=self.keep, tn_fullseq=self.tn_fullseq, stage=stage)
        with torch.inference_mode():
            vec, spec = pack_clip_outputs(body(raw, w_final, h_final))
        return vec, spec, fc, skip

    def _fetch(self, vec, spec, fc: int, skip: int) -> dict:
        """One device-to-host copy, unpacked; raises if the clip overran
        the static bounds."""
        out = unpack_clip_outputs(vec.cpu().numpy(), spec)
        out['fc_sel'] = int(out['fc_sel'])
        out['n_segments'] = int(out['n_segments'])
        t_sel_pad = self._t_sel_pad(fc, skip)
        if out['n_segments'] > self.s_pad or out['fc_sel'] > t_sel_pad:
            raise ValueError(
                f'clip exceeds one-shot static bounds '
                f'({out["n_segments"]} shots > s_pad={self.s_pad} or '
                f'{out["fc_sel"]} picks > t_sel_pad={t_sel_pad}); '
                'use the two-dispatch path (pipeline.fused.'
                'FusedClipProgram)')
        return out

    def dispatch(self, raw_frames, crop_params: dict, *, fps: float,
                 w_final: int, h_final: int):
        """Run the clip up to the packed output vector on the device;
        returns a ticket for :meth:`collect`."""
        return self._dispatch(raw_frames, crop_params, fps, int(w_final),
                              int(h_final))

    def collect(self, ticket) -> dict:
        """Fetch and unpack a :meth:`dispatch` ticket; raises if the clip
        overran the static bounds."""
        vec, spec, fc, skip = ticket
        out = self._fetch(vec, spec, fc, skip)
        out['boxes'] = out['boxes'][:fc].astype(np.int32)
        return out

    def run(self, raw_frames, crop_params: dict, *, fps: float,
            w_final: int, h_final: int) -> dict:
        """(fc, H, W, 3) uint8 frames -> outputs dict (numpy)."""
        return self.collect(self.dispatch(raw_frames, crop_params, fps=fps,
                                          w_final=w_final, h_final=h_final))

    def dispatch_multi(self, raw_frames, crop_params: dict, *, fps: float,
                       dests):
        """One pass for R output ratios, ``dests`` a sequence of
        (w_final, h_final): resizes, TransNet, sampling, scenes, UNISAL, the
        postprocess kernel and the geometry up to the smoothed series run
        once; only the crop-box tail runs per ratio.  Returns a ticket for
        :meth:`collect_multi`."""
        dests = [(int(wf), int(hf)) for wf, hf in dests]
        if not dests:
            raise ValueError('dispatch_multi needs at least one destination')
        vec, spec, fc, skip = self._dispatch(
            raw_frames, crop_params, fps, tuple(d[0] for d in dests),
            tuple(d[1] for d in dests))
        return vec, spec, fc, skip, len(dests)

    def collect_multi(self, ticket) -> list:
        """Fetch a :meth:`dispatch_multi` ticket -> one outputs dict per
        ratio (ratio-independent keys repeated in each)."""
        vec, spec, fc, skip, n_ratios = ticket
        out = self._fetch(vec, spec, fc, skip)
        outs = []
        for r in range(n_ratios):
            o = {k: (v[r] if k in RATIO_KEYS else v) for k, v in out.items()}
            o['boxes'] = o['boxes'][:fc].astype(np.int32)
            outs.append(o)
        return outs
