"""Video ingest: decode, shot detection, frame sampling, saliency volume.

Port of ``retargetvid_tpu/pipeline/ingest.py`` (reference
``read_and_segment_video``, ``smartVidCrop.py:234-556``, and
``ingest_pickle``, ``:560-836``):

- frames decode on a host thread and reach the device in chunks of 256,
  each resized once on the device (27x48 for TransNet, max-dim 250 for
  saliency, both linear, quantized round-half-up to uint8);
- shot probabilities come per read batch of ``read_batch`` frames, with
  the reference's ``int(fps - 5)``-frame overlap stitching: a zero-filled
  first overlap, the previous batch's tail after that, and a 75-frame zero
  tail behind every batch;
- frame sampling carries ``true_inds`` across batches: every ``skip``
  frames from the last pick, the frame after each shot cut and the final
  frame; saliency runs on each batch's picks;
- the scene list from thresholded probabilities with the boundary fix.

A cut is a probability above the shot detector's own threshold
(``models.transnet.cut_threshold`` of ``transnet_fn``: 0.1 for TransNet
V1 and any detector that states none, 0.5 for TransNet V2).

:func:`read_and_segment_video` probes and opens the file; the chunk loop is
:func:`segment_chunks`, which takes any iterator of ``(chunk, start)``
pairs (a decoded file or frames already in memory).  Both return the
``vid_data`` dict (reference contract: ``smaps``, ``segmentation``,
``segmentation_sel``, ``true_inds``, ``inds_to_orig``, ``fr``, ``fc``,
``fc_sel``, ``h/w_orig``, ``h/w_process``) with ``smaps`` (T, H, W) and
``layout='thw'``.

The reference's per-batch off-by-one (the last selected frame of each read
batch never receives its saliency map) is replicated by default, as in the
JAX package; ``crop_params['tpu_fix_batch_tail']=True`` turns it off.
"""

from __future__ import annotations

import pickle
import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from retargetvid_tpu_torch.config import TRANS_THRESHOLD, sal_dims
from retargetvid_tpu_torch.device import resolve_device
from retargetvid_tpu_torch.models.transnet import (
    INPUT_HEIGHT,
    INPUT_WIDTH,
    IngestShotProgram,
    cut_threshold,
)
from retargetvid_tpu_torch.ops.resize import resize, round_half_up
from retargetvid_tpu_torch.ops.scenes import (
    fix_scene_bounds,
    predictions_to_scenes,
    scenes_to_selected,
)
from retargetvid_tpu_torch.utils.timing import sc_register_time

__all__ = ["TRANSNET_H", "TRANSNET_W", "TRANS_THRESHOLD", "sal_dims",
           "sample_frames", "read_and_segment_video", "segment_chunks",
           "ingest_pickle", "load_vid_data", "save_vid_data",
           "read_video_structure"]

TRANSNET_H = INPUT_HEIGHT
TRANSNET_W = INPUT_WIDTH
#: Frames per device chunk of the streaming ingest.
DEVICE_CHUNK = 256
#: Zero frames behind each read batch's TransNet context: the reference
#: predicts over a zero-filled buffer, and only ~75 trailing zero frames
#: can reach the probabilities that are kept.
ZERO_TAIL = 75


def _to_u8(v: torch.Tensor) -> torch.Tensor:
    return torch.clamp(round_half_up(v), 0, 255).to(torch.uint8)


def _resize_kernel(h: int, w: int, sal_h: int, sal_w: int):
    """The ingest's two resizes of (N, h, w, 3) uint8 frames: a function
    giving (27x48 TransNet frames, sal_h x sal_w saliency frames), both
    linear and quantized round-half-up to uint8."""

    def fn(frames: torch.Tensor):
        if tuple(frames.shape[1:]) != (h, w, 3):
            raise ValueError(f'frames must be (N, {h}, {w}, 3), got '
                             f'{tuple(frames.shape)}')
        tn = _to_u8(resize(frames, (TRANSNET_H, TRANSNET_W), 'linear',
                           channels_last=True))
        sal = _to_u8(resize(frames, (sal_h, sal_w), 'linear',
                            channels_last=True))
        return tn, sal

    return fn


def sample_frames(n_frames: int, trans_probs: np.ndarray, skip: int,
                  frame_count: int, start: int = 0,
                  prev_true_inds: Optional[list] = None,
                  threshold: float = TRANS_THRESHOLD):
    """Reference frame-selection rule over one batch (``:379-399``).

    Selects frame start+i when it is exactly ``skip`` after the last
    selected frame, follows a frame whose transition probability exceeded
    ``threshold``, is the first frame ever, or is the video's final frame.
    Returns (selected_local_indices, true_inds, map2orig_additions).
    """
    true_inds = prev_true_inds if prev_true_inds is not None else []
    selected = []
    map2orig = []
    total = len(true_inds) - 1
    for i in range(n_frames):
        f = start + i
        want = (f == true_inds[-1] + skip) if true_inds else True
        after_shot_change = f > 0 and bool(
            trans_probs[f - 1] > threshold)
        if want or after_shot_change or f == frame_count - 1:
            total += 1
            selected.append(i)
            true_inds.append(f)
        map2orig.append(total)
    return selected, true_inds, map2orig


def _zero_last(maps):
    """The reference's per-batch off-by-one: the batch's last selected map
    stays zero (``smartVidCrop.py:409-421``)."""
    maps = maps.clone() if torch.is_tensor(maps) else np.array(maps)
    maps[-1] = 0
    return maps


def _concat(parts, empty_hw):
    """The batches' maps as one volume; ``saliency_fn`` gives all of them
    as numpy or all as tensors."""
    if not parts:
        return np.zeros((0,) + tuple(empty_hw), np.uint8)
    if len(parts) == 1:
        return parts[0]
    return (torch.cat(parts) if torch.is_tensor(parts[0])
            else np.concatenate(parts))


def read_and_segment_video(video_path, crop_params: dict,
                           transnet_fn: Callable, saliency_fn: Callable,
                           verbose: bool = False, device=None) -> dict:
    """Decode + shot detect + sample + saliency of a video file.

    ``transnet_fn``: (N, 27, 48, 3) uint8 -> (N,) probabilities (for
    example ``models.transnet.TransNetPredictor``); ``saliency_fn``:
    (T, SAL_H, SAL_W, 3) uint8 -> (T, SAL_H, SAL_W) uint8 (for example
    ``SaliencyPredictor.predict``).  ``device=None`` means the GPU.  See
    :func:`segment_chunks`.
    """
    del verbose                             # accepted for signature parity
    from retargetvid_tpu_torch.io.native_reader import open_reader
    from retargetvid_tpu_torch.io.video import probe_video

    t0 = time.perf_counter()
    info = probe_video(video_path)
    sc_register_time(t0, 'read_init')
    reader = open_reader(video_path)
    try:
        return segment_chunks(info, reader.chunks(DEVICE_CHUNK), crop_params,
                              transnet_fn, saliency_fn, device=device)
    finally:
        reader.stop()


def segment_chunks(info: dict, chunks: Iterable, crop_params: dict,
                   transnet_fn: Callable, saliency_fn: Callable, *,
                   device=None) -> dict:
    """The streaming ingest's chunk loop.

    ``info``: the probe dict (``fps``, ``frame_count``, ``width``,
    ``height``); ``chunks``: ``(chunk, start)`` pairs of (k, H, W, 3) uint8
    frames in order, numpy or tensors.  Each chunk is moved to ``device``
    (``None`` means the GPU) and resized there once.  Unless
    ``crop_params['tpu_fix_batch_tail']``, the last selected map of each
    read batch is zeroed, as the reference does.
    """
    quirk_batch_tail = not crop_params.get('tpu_fix_batch_tail', False)
    dev = resolve_device(device)
    fr, frame_count = info['fps'], info['frame_count']
    w, h = info['width'], info['height']
    batch_size = crop_params['read_batch']
    batch_overlap = int(fr - 5)
    skip = crop_params['skip']
    threshold = cut_threshold(transnet_fn)
    sal_h, sal_w = sal_dims(w, h, crop_params['max_input_d'])
    kernel = _resize_kernel(h, w, sal_h, sal_w)

    trans_probs: list = []
    true_inds: list = []
    map2orig: list = []
    smaps_parts: list = []
    tn_parts: list = []
    sal_parts: list = []
    tn_tail = torch.zeros((max(batch_overlap, 0), TRANSNET_H, TRANSNET_W, 3),
                          dtype=torch.uint8, device=dev)
    zero_tail = torch.zeros((ZERO_TAIL, TRANSNET_H, TRANSNET_W, 3),
                            dtype=torch.uint8, device=dev)
    bsi = 0
    batch_start = 0

    def flush_batch(cur_len):
        nonlocal tn_tail, tn_parts, sal_parts, bsi, batch_start
        tn_batch = torch.cat(tn_parts) if len(tn_parts) > 1 else tn_parts[0]
        sal_batch = (torch.cat(sal_parts) if len(sal_parts) > 1
                     else sal_parts[0])
        tn_context = torch.cat(
            ([tn_tail] if batch_overlap > 0 else []) + [tn_batch, zero_tail])

        t = time.perf_counter()
        probs = np.asarray(transnet_fn(tn_context))
        for i in range(cur_len):
            trans_probs.append(float(probs[batch_overlap + i]))
        sc_register_time(t, '_read_shot_det')

        t = time.perf_counter()
        selected, _, m2o = sample_frames(
            cur_len, np.array(trans_probs), skip, frame_count,
            start=batch_start, prev_true_inds=true_inds, threshold=threshold)
        map2orig.extend(m2o)
        if selected:
            sm = saliency_fn(sal_batch[torch.as_tensor(selected,
                                                       device=dev)])
            smaps_parts.append(_zero_last(sm) if quirk_batch_tail else sm)
        sc_register_time(t, '_read_sal_det')

        if batch_overlap > 0:
            tn_tail = tn_batch[-batch_overlap:]
        batch_start += cur_len
        bsi = 0
        tn_parts, sal_parts = [], []

    total_read = 0
    t_read = time.perf_counter()
    with torch.inference_mode():
        for chunk, _ in chunks:
            tn, sal = kernel(torch.as_tensor(chunk).to(dev))
            k = int(tn.shape[0])
            total_read += k
            pos = 0
            while pos < k:
                take = min(batch_size - bsi, k - pos)
                tn_parts.append(tn[pos:pos + take])
                sal_parts.append(sal[pos:pos + take])
                bsi += take
                pos += take
                if bsi == batch_size:
                    flush_batch(batch_size)
        sc_register_time(t_read, '_read')
        if bsi > 0:
            flush_batch(bsi)

    t_tidy = time.perf_counter()
    vid_data = _finish_vid_data(
        np.array(trans_probs), total_read, map2orig, true_inds,
        _concat(smaps_parts, (sal_h, sal_w)), fr, h, w, (sal_h, sal_w),
        frame_count, threshold)
    sc_register_time(t_tidy, 'read_tidy')
    return vid_data


def _finish_vid_data(probs, n, map2orig, true_inds, smaps, fr, h, w,
                     sal_hw, frame_count,
                     threshold: float = TRANS_THRESHOLD) -> dict:
    """The ``vid_data`` dict of ``n`` ingested frames: the scene list from
    the probabilities above ``threshold`` with the boundary fix, its
    selected-frame counterpart, and the sanity checks."""
    segmentation = predictions_to_scenes(probs, threshold=threshold)
    segmentation = fix_scene_bounds(segmentation, n)
    vid_data = {
        'layout': 'thw',
        'smaps': smaps,
        'segmentation': segmentation,
        'segmentation_sel': scenes_to_selected(segmentation, map2orig),
        'true_inds': true_inds,
        'inds_to_orig': map2orig,
        'fr': fr,
        'fc': n,
        'fc_sel': int(smaps.shape[0]),
        'h_orig': h, 'w_orig': w,
        'h_process': sal_hw[0], 'w_process': sal_hw[1],
    }
    _sanity_checks(vid_data, frame_count)
    return vid_data


def _sanity_checks(vd: dict, frame_count: int):
    """The reference's seven structural invariants (``:519-545``), raising."""
    problems = []
    if vd['fc'] > frame_count:
        problems.append('fc exceeds container frame count')
    if vd['fc_sel'] != len(vd['true_inds']):
        problems.append('fc_sel != len(true_inds)')
    if vd['fc'] != len(vd['inds_to_orig']):
        problems.append('fc != len(inds_to_orig)')
    if vd['fc_sel'] != vd['smaps'].shape[0]:
        problems.append('fc_sel != smaps frames')
    if vd['segmentation'][-1][-1] != vd['fc'] - 1:
        problems.append('segmentation end mismatch')
    if vd['segmentation_sel'][-1][-1] != vd['fc_sel'] - 1:
        problems.append('segmentation_sel end mismatch')
    if vd['inds_to_orig'][-1] != vd['fc_sel'] - 1:
        problems.append('inds_to_orig tail mismatch')
    if problems:
        raise ValueError('ingest sanity checks failed: ' + '; '.join(problems))


def ingest_pickle(pkl_path, crop_params: dict, saliency_fn: Callable,
                  verbose: bool = False, device=None) -> dict:
    """Ingest the reference's web-service pickle contract (``:560-836``).

    The pickle holds ``fr``, ``frame_count``, ``w``, ``h``, ``frames``
    (decoded RGB uint8) and precomputed ``trans_inds`` shot-cut indices;
    TransNet is skipped.  ``device=None`` means the GPU.  Unpickle only
    files this program or a trusted client wrote.
    """
    del verbose                             # accepted for signature parity
    dev = resolve_device(device)
    with open(pkl_path, 'rb') as fp:
        data = pickle.load(fp)
    fr = data['fr']
    frame_count = int(data['frame_count'])
    w, h = int(data['w']), int(data['h'])
    frames = np.asarray(data['frames'])
    trans_inds = list(data.get('trans_inds', []))
    skip = crop_params['skip']

    sal_h, sal_w = sal_dims(w, h, crop_params['max_input_d'])
    kernel = _resize_kernel(frames.shape[1], frames.shape[2], sal_h, sal_w)
    with torch.inference_mode():
        _, sal_frames = kernel(torch.from_numpy(frames).to(dev))

    n = len(frames)
    probs = np.zeros(n, np.float32)
    for ti in trans_inds:
        if 0 <= ti < n:
            probs[ti] = 1.0

    selected, true_inds, map2orig = sample_frames(
        n, probs, skip, n, start=0, prev_true_inds=None)
    smaps = saliency_fn(sal_frames[torch.as_tensor(selected, device=dev)])
    if not crop_params.get('tpu_fix_batch_tail', False) and len(smaps):
        smaps = _zero_last(smaps)

    return _finish_vid_data(probs, n, map2orig, true_inds, smaps, fr, h, w,
                            (sal_h, sal_w), frame_count)


def load_vid_data(path) -> dict:
    """Load a cached ``vid_data`` pickle; the reference's (H, W, T) smaps
    layout is converted to (T, H, W)."""
    with open(path, 'rb') as fp:
        vd = pickle.load(fp)
    if vd.get('layout') != 'thw':
        vd['smaps'] = np.moveaxis(vd['smaps'], -1, 0)
        vd['layout'] = 'thw'
    return vd


def save_vid_data(path, vd: dict) -> None:
    vd = dict(vd)
    smaps = vd['smaps']
    vd['smaps'] = (smaps.cpu().numpy() if torch.is_tensor(smaps)
                   else np.asarray(smaps))
    with open(path, 'wb') as fp:
        pickle.dump(vd, fp)


def read_video_structure(video_path, crop_params: dict,
                         transnet_fn: Callable, device=None) -> dict:
    """Decode, resize, shot-detect and sample a video, deferring saliency.

    Returns the clip dict that ``parallel.runner.ShardedClipRunner`` and
    ``group_clips`` take: ``sal_frames`` (the whole saliency-resolution
    volume, numpy uint8), ``selected``, ``true_inds``, ``segmentation``,
    ``segmentation_sel``, ``fc``, ``fps``, ``h_orig``, ``w_orig``.  Frames
    reach ``device`` (``None``: the GPU) in chunks of 256 and are resized
    there.  A clip of at most ``read_batch`` frames is shot-detected whole
    (``transnet_fn`` on the 27x48 frames, or an ``IngestShotProgram`` on the
    raw ones); a longer clip in the streaming ingest's read batches, each
    behind the previous batch's ``int(fps - 5)``-frame tail (zeros first)
    with a 75-frame zero tail, an ``IngestShotProgram`` through its
    ``TransNetPredictor``.  Sampling and scenes run on the host.
    """
    from retargetvid_tpu_torch.io.native_reader import open_reader
    from retargetvid_tpu_torch.io.video import probe_video

    dev = resolve_device(device)
    info = probe_video(video_path)
    fr, w, h = info['fps'], info['width'], info['height']
    skip = crop_params['skip']
    sal_h, sal_w = sal_dims(w, h, crop_params['max_input_d'])
    kernel = _resize_kernel(h, w, sal_h, sal_w)

    reader = open_reader(video_path)
    try:
        parts = [torch.as_tensor(chunk).to(dev)
                 for chunk, _ in reader.chunks(DEVICE_CHUNK)]
    finally:
        reader.stop()
    raw = torch.cat(parts) if len(parts) > 1 else parts[0]
    fc = int(raw.shape[0])

    read_batch = crop_params['read_batch']
    with torch.inference_mode():
        if fc > read_batch:
            batch_overlap = int(fr - 5)
            tn_all, sal_frames = kernel(raw)
            probs_fn = (transnet_fn.predictor
                        if isinstance(transnet_fn, IngestShotProgram)
                        else transnet_fn)
            tail = tn_all.new_zeros((max(batch_overlap, 0),)
                                    + tuple(tn_all.shape[1:]))
            zero_tail = tn_all.new_zeros((ZERO_TAIL,)
                                         + tuple(tn_all.shape[1:]))
            probs_parts = []
            for start in range(0, fc, read_batch):
                batch = tn_all[start:start + read_batch]
                context = torch.cat(([tail] if batch_overlap > 0 else [])
                                    + [batch, zero_tail])
                p = np.asarray(probs_fn(context))
                probs_parts.append(
                    p[batch_overlap:batch_overlap + len(batch)])
                if batch_overlap > 0:
                    tail = batch[-batch_overlap:]
            probs = np.concatenate(probs_parts)
        elif isinstance(transnet_fn, IngestShotProgram):
            sal_frames, probs = transnet_fn(raw)
        else:
            tn, sal_frames = kernel(raw)
            probs = np.asarray(transnet_fn(tn))
    threshold = cut_threshold(transnet_fn)
    selected, true_inds, map2orig = sample_frames(fc, probs, skip, fc,
                                                  threshold=threshold)
    segmentation = fix_scene_bounds(
        predictions_to_scenes(probs, threshold=threshold), fc)
    return {
        'sal_frames': sal_frames.cpu().numpy(),
        'selected': selected,
        'true_inds': true_inds,
        'segmentation': segmentation,
        'segmentation_sel': scenes_to_selected(segmentation, map2orig),
        'fc': fc,
        'fps': fr,
        'h_orig': h, 'w_orig': w,
    }
