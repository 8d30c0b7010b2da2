"""Multi-GPU benchmark execution: clips split over the mesh's dp axis.

Port of ``retargetvid_tpu/parallel/runner.py``.  The benchmark is
embarrassingly parallel over videos: each dp rank runs one clip of a batch
(or its share of a frame batch) on its own GPU, with no collective on the
hot path; the KB-scale outputs are all-gathered at the end
(``parallel.distributed.global_fetch``), so every rank returns the whole
batch, as the JAX package's replicated fetch does.  Every rank holds the
batch's host data; ranks that share a dp index (sp or tp above 1) compute
the same clip.

- :class:`ShardedOneShot`: the whole-clip one-shot body
  (``pipeline.oneshot.make_oneshot_body``) per rank, the clips of a batch
  padded to one frame capacity and each run at its live count;
- :class:`ShardedClipRunner`: the two-dispatch path's clip body
  (``pipeline.fused.make_clip_fn``) over ``read_video_structure`` dicts;
- :class:`ShardedSaliency`: static UNISAL over a frame batch split in
  ``per_chip`` frames per rank.

All three reach the saliency-postprocess CUDA kernel on the card.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from retargetvid_tpu_torch.config import sal_dims
from retargetvid_tpu_torch.device import resolve_device
from retargetvid_tpu_torch.kernels.postprocess import saliency_postprocess
from retargetvid_tpu_torch.parallel.distributed import global_fetch
from retargetvid_tpu_torch.pipeline.fused import (
    make_clip_fn,
    pack_clip_outputs,
    unpack_clip_outputs,
)
from retargetvid_tpu_torch.pipeline.geometry import (
    GeometryConfig,
    bucket_size,
    seg_bucket_size,
)
from retargetvid_tpu_torch.pipeline.oneshot import make_oneshot_body
from retargetvid_tpu_torch.pipeline.saliency import (
    get_optimal_out_size,
    preprocess_frames,
)

__all__ = ["ShardedSaliency", "ShardedClipRunner", "ShardedOneShot",
           "group_clips", "group_raw_clips", "clip_signature",
           "raw_clip_signature"]


def _check_batch(mesh, items, what: str) -> None:
    dp = mesh.shape['dp']
    if len(items) != dp:
        raise ValueError(f'{what}: a batch holds one clip per dp rank '
                         f'({dp}), got {len(items)}')


def _pad_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x`` with zero rows appended up to ``n`` rows."""
    if x.shape[0] == n:
        return x
    return torch.cat([x, x.new_zeros((n - x.shape[0],) + tuple(x.shape[1:]))])


def _padded(vals, n: int) -> np.ndarray:
    out = np.zeros(n, np.int64)
    out[:len(vals)] = np.asarray(vals, np.int64)
    return out


class ShardedClipRunner:
    """Whole clips split over dp: each rank runs one clip's post-shot-
    detection pipeline (gather, saliency, geometry) of a batch whose clips
    share one bucket signature (:func:`group_clips`).

    ``un_model`` is a ``UNISAL`` module; ``dtype`` its input's dtype.  It
    runs on the mesh's device.
    """

    def __init__(self, mesh, un_model, source: str = 'SALICON',
                 dtype=torch.float32, t_border: int = -1):
        self.mesh = mesh
        self.device = mesh.device
        self.un_model = un_model.to(self.device).eval()
        self.source = source
        self.dtype = dtype
        self.t_border = t_border

    def run_batch(self, clips, crop_params: dict, *, fps: float,
                  h_orig: int, w_orig: int, w_final: int, h_final: int,
                  seg_bucket: Optional[int] = None) -> list:
        """Run a dp-sized batch of clips sharing one bucket signature.

        ``clips``: dicts with ``sal_frames`` (T_all, H, W, 3) uint8,
        ``selected``, ``true_inds``, ``segmentation``, ``segmentation_sel``
        and ``fc`` (``pipeline.ingest.read_video_structure``'s).  The frames
        pad to the bucket of the batch's longest, the picks and
        ``true_inds`` (continued ascending) to the bucket of its most picks,
        the segment columns to ``seg_bucket_size`` of its most segments (or
        ``seg_bucket``).  Returns one dict per clip: ``boxes`` trimmed to
        its ``fc`` and ``mean_sal``.
        """
        _check_batch(self.mesh, clips, 'ShardedClipRunner')
        cfg = GeometryConfig.from_crop_params(crop_params)
        t_sel_pad = bucket_size(max(len(c['selected']) for c in clips))
        t_out = bucket_size(max(int(c['fc']) for c in clips))
        s_pad = (seg_bucket_size(max(len(c['segmentation']) for c in clips))
                 if seg_bucket is None else seg_bucket)
        t_all_pad = bucket_size(max(int(c['sal_frames'].shape[0])
                                    for c in clips))
        h, w = (int(s) for s in clips[0]['sal_frames'].shape[1:3])

        c = clips[self.mesh.dp_index]
        n_sel, n_seg = len(c['selected']), len(c['segmentation'])
        if n_seg > s_pad:
            raise ValueError(f'{n_seg} segments exceed seg_bucket {s_pad}')
        ti = _padded(c['true_inds'], t_sel_pad)
        ti[n_sel:] = ti[n_sel - 1] + np.arange(1, t_sel_pad - n_sel + 1)
        cols = [_padded(np.asarray(c[key])[:, col], s_pad)
                for key in ('segmentation', 'segmentation_sel')
                for col in (0, 1)]

        def dev(arr):
            return torch.from_numpy(arr).to(self.device)

        clip_fn = make_clip_fn(
            self.un_model, source=self.source, dtype=self.dtype,
            t_border=self.t_border, cfg=cfg, in_hw=(h, w),
            net_hw=get_optimal_out_size((h, w)), t_out=t_out,
            fps=float(fps), h_orig=int(h_orig), w_orig=int(w_orig))
        with torch.inference_mode():
            frames = _pad_rows(torch.as_tensor(c['sal_frames']).to(
                self.device), t_all_pad)
            vec, spec = pack_clip_outputs(clip_fn(
                frames, dev(_padded(c['selected'], t_sel_pad)),
                dev(np.arange(t_sel_pad) < n_sel), n_sel, dev(ti),
                *(dev(col) for col in cols), n_seg, int(c['fc']),
                int(w_final), int(h_final)))
        vecs = global_fetch(vec, self.mesh)
        results = []
        for i, clip in enumerate(clips):
            out = unpack_clip_outputs(vecs[i], spec)
            results.append({'boxes': out['boxes'][:int(clip['fc'])],
                            'mean_sal': out['mean_sal']})
        return results


class ShardedOneShot:
    """The whole-clip one-shot program, one clip per dp rank.

    ``make_oneshot_body`` (resizes, TransNet, sampling and scenes on the
    device, saliency, geometry) runs on each rank's clip, padded to the
    batch's frame capacity with its live count as ``n``; the packed output
    vectors are all-gathered.  Arguments as ``OneShotClipProgram``'s, plus
    the static-capacity overrides ``fc_bucket`` (frame capacity for batches
    whose clips all fit it) and ``t_sel_bucket`` (pick capacity); a clip
    beyond them is flagged like any other overrun.  ``device=None`` means
    the mesh's device.
    """

    def __init__(self, mesh, tn_model, un_model, source: str = 'SALICON',
                 dtype=torch.bfloat16, t_border: int = -1, s_pad: int = 8,
                 window: int = 100, stride: int = 50,
                 keep: tuple = (25, 75), tn_fullseq: bool = False,
                 fc_bucket: Optional[int] = None,
                 t_sel_bucket: Optional[int] = None, device=None):
        if window % stride:
            raise ValueError('window must be a multiple of stride')
        self.mesh = mesh
        self.device = mesh.device if device is None else \
            resolve_device(device)
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
        self.fc_bucket = fc_bucket
        self.t_sel_bucket = t_sel_bucket

    def dispatch_batch(self, raws, crop_params: dict, *, fps: float,
                       w_final: int, h_final: int):
        """Run this rank's clip of a dp-sized batch up to its packed output
        vector; returns a ticket for :meth:`collect_batch`.  ``raws``: the
        whole batch, (fc_i, H, W, 3) uint8 each, one H and W."""
        _check_batch(self.mesh, raws, 'ShardedOneShot')
        fcs = [int(r.shape[0]) for r in raws]
        h, w = int(raws[0].shape[1]), int(raws[0].shape[2])
        if any(tuple(r.shape[1:]) != (h, w, 3) for r in raws):
            raise ValueError('the clips of a batch must share H and W')
        if self.fc_bucket and max(fcs) <= self.fc_bucket:
            fc_cap = self.fc_bucket
        else:
            fc_cap = bucket_size(max(fcs))
        skip = int(crop_params['skip'])
        t_sel_pad = self.t_sel_bucket or \
            bucket_size(fc_cap // skip + 2 + self.s_pad)
        sal_hw = sal_dims(w, h, crop_params['max_input_d'])
        body = make_oneshot_body(
            self.un_model, self.tn_model, source=self.source,
            dtype=self.dtype, t_border=self.t_border,
            cfg=GeometryConfig.from_crop_params(crop_params), fc=fc_cap,
            sal_hw=sal_hw, net_hw=get_optimal_out_size(sal_hw),
            t_out=fc_cap if self.fc_bucket else bucket_size(fc_cap),
            t_sel_pad=t_sel_pad, s_pad=self.s_pad, skip=skip,
            fps=float(fps), h_orig=h, w_orig=w, window=self.window,
            stride=self.stride, keep=self.keep, tn_fullseq=self.tn_fullseq)
        i = self.mesh.dp_index
        raw = torch.as_tensor(raws[i]).to(self.device)
        if raw.dtype != torch.uint8:
            raise ValueError(f'raw frames must be uint8, got {raw.dtype}')
        with torch.inference_mode():
            vec, spec = pack_clip_outputs(body(
                _pad_rows(raw, fc_cap), int(w_final), int(h_final),
                n=fcs[i]))
        return vec, spec, fcs, t_sel_pad

    def collect_batch(self, ticket) -> list:
        """Gather and unpack a :meth:`dispatch_batch` ticket: one outputs
        dict per clip (``OneShotClipProgram.run``'s keys, boxes trimmed to
        the clip) with ``overrun`` set where the clip exceeded the static
        pick or shot bounds; the caller serves those another way."""
        vec, spec, fcs, t_sel_pad = ticket
        vecs = global_fetch(vec, self.mesh)
        results = []
        for i, fc in enumerate(fcs):
            out = unpack_clip_outputs(vecs[i], spec)
            out['boxes'] = out['boxes'][:fc].astype(np.int32)
            out['fc_sel'] = int(out['fc_sel'])
            out['n_segments'] = int(out['n_segments'])
            out['overrun'] = (out['n_segments'] > self.s_pad or
                              out['fc_sel'] > t_sel_pad)
            results.append(out)
        return results

    def run_batch(self, raws, crop_params: dict, *, fps: float,
                  w_final: int, h_final: int) -> list:
        """Run a dp-sized batch of raw clips sharing one signature
        (:func:`group_raw_clips`); see :meth:`collect_batch`."""
        return self.collect_batch(self.dispatch_batch(
            raws, crop_params, fps=fps, w_final=w_final, h_final=h_final))


def raw_clip_signature(raw, fps) -> tuple:
    """What shapes the one-shot run of a raw clip: (H, W, frame-capacity
    bucket, fps)."""
    fc, h, w = raw.shape[:3]
    return (int(h), int(w), bucket_size(int(fc)), float(fps))


def clip_signature(c) -> tuple:
    """What shapes the clip runner's run of a clip: (H, W, frame-count
    bucket, pick bucket, fc bucket, segment bucket)."""
    t_all, h, w = c['sal_frames'].shape[:3]
    return (int(h), int(w), bucket_size(int(t_all)),
            bucket_size(len(c['selected'])), bucket_size(int(c['fc'])),
            seg_bucket_size(len(c['segmentation'])))


def _group(items, dp: int, signature) -> list:
    """dp-sized batches of one signature each, in arrival order per
    signature; a final partial batch repeats its last item (whose outputs
    the caller drops).  Returns (batch, n_real) tuples."""
    pools: dict = {}
    for it in items:
        pools.setdefault(signature(it), []).append(it)
    batches = []
    for pool in pools.values():
        for i in range(0, len(pool), dp):
            batch = pool[i:i + dp]
            n_real = len(batch)
            batch += [batch[-1]] * (dp - n_real)
            batches.append((batch, n_real))
    return batches


def group_raw_clips(items, dp: int) -> list:
    """Schedule ``{'raw': (fc, H, W, 3), 'fps': ..}`` items into dp-sized
    batches of one :func:`raw_clip_signature`."""
    return _group(items, dp, lambda it: raw_clip_signature(it['raw'],
                                                           it['fps']))


def group_clips(clips, dp: int) -> list:
    """Schedule clip dicts into dp-sized batches of one
    :func:`clip_signature`."""
    return _group(clips, dp, clip_signature)


class ShardedSaliency:
    """Static UNISAL saliency with the frame batch split over dp.

    ``predict(frames)``: (T, H, W, 3) uint8 (any number of clips
    concatenated, the same on every rank) -> (T, H, W) uint8 numpy maps.
    Frames go through in chunks of ``dp * per_chip`` (the last padded by
    repeating its last frame); each rank runs its ``per_chip`` frames of a
    chunk (Lanczos preprocess, UNISAL, one postprocess kernel launch) and
    the maps are all-gathered.  It runs on the mesh's device.
    """

    def __init__(self, mesh, un_model, source: str = 'SALICON',
                 per_chip: int = 16, dtype=torch.float32):
        self.mesh = mesh
        self.device = mesh.device
        self.un_model = un_model.to(self.device).eval()
        self.source = source
        self.per_chip = per_chip
        self.dtype = dtype
        self.batch = per_chip * mesh.shape['dp']

    def predict(self, frames) -> np.ndarray:
        frames = torch.as_tensor(frames)
        t, h, w, _ = frames.shape
        net_hw = get_optimal_out_size((h, w))
        out = np.empty((t, h, w), np.uint8)
        lo = self.mesh.dp_index * self.per_chip
        for s in range(0, t, self.batch):
            # This rank's frames of the chunk; past the clip, the last frame.
            idx = torch.clamp(torch.arange(s + lo, s + lo + self.per_chip),
                              max=t - 1).to(frames.device)
            with torch.inference_mode():
                x = preprocess_frames(frames[idx].to(self.device), net_hw)
                logp = self.un_model(x.to(self.dtype)[:, None],
                                     target_size=(h, w), source=self.source)
                maps = saliency_postprocess(
                    logp[:, 0, :, :, 0].to(torch.float32).contiguous())
            e = min(t, s + self.batch)
            out[s:e] = global_fetch(maps, self.mesh).reshape(
                self.batch, h, w)[:e - s]
        return out

