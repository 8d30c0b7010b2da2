"""The plain reference of the benchmark's two entry paths.

:func:`crop_clip`: SmartVidCrop on one clip of raw uint8 frames, the
reference's order of work: two linear ingest resizes quantised to uint8,
TransNetV1's full-sequence plan, the sequential frame-sampling rule and the
scene list on the host (``smartVidCrop.py:214-230, 379-399, 459-474``),
UNISAL's static forward on the live picks only, the postprocess arithmetic,
the reference ingest's zeroed last map, and the geometry chain with one box
tail per output ratio.

:func:`saliency_video`: UNISAL's dynamic mode over a whole clip, the
reference's interleaved frame-modulo scheme (``unisal/train.py:425-556``):
each phase-offset subsequence in ``seq_len``-frame chunks, the ConvGRU's
hidden state carried across chunks, then the postprocess arithmetic.

Everything here is plain PyTorch and NumPy, on whatever device the inputs
are; the caller sets the precision (float32 with TF32 off for the
reference).  The modules beside this one are frozen copies of the
repository port's plain code (``ops/``, ``pipeline/geometry.py``) and of its
models cut to inference, so that the benchmark's yardstick does not move
with the program.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.border import border_detection, mean_saliency
from portbench.reference.geometry import (
    GeometryConfig,
    bucket_size,
    geometry_boxes,
    geometry_series,
    pad_clip_tables,
)
from portbench.reference.resize import resize, round_half_up
from portbench.reference.transnet import fullseq_forward

TRANS_THRESHOLD = 0.1          # smartVidCrop.py:64
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def sal_dims(w: int, h: int, max_input_d: int):
    dsr = float(max(w, h)) / max_input_d
    return int(h / dsr), int(w / dsr)


def dest_size(w: int, h: int, ratio: str):
    """(w_final, h_final) of an output ratio ``'a:b'`` (the reference's
    ``calc_dest_size``: the full side kept, the other cut, even)."""
    from portbench.reference.boxes import calc_dest_size
    d = calc_dest_size(w, h, ratio)
    return int(d['w_final']), int(d['h_final'])


def net_size(img_hw):
    """The x32 network grid best matching the aspect ratio."""
    ar = img_hw[0] / img_hw[1]
    best, best_ratio = None, -1.0
    for n1 in range(7, 14):
        for n2 in range(7, 14):
            if 100 <= n1 * n2 <= 120:
                this_ar = n1 / n2
                ratio = min(ar, this_ar) / max(ar, this_ar)
                if ratio > best_ratio:
                    best_ratio, best = ratio, (n1, n2)
    return best[0] * 32, best[1] * 32


def to_u8(v):
    return torch.clamp(round_half_up(v), 0, 255).to(torch.uint8)


def preprocess(frames, out_hw):
    """uint8 (B, H, W, 3) -> PIL-Lanczos to ``out_hw``, uint8 rounding,
    /255, ImageNet normalisation."""
    x = resize(frames, out_hw, 'lanczos', channels_last=True)
    x = torch.clamp(round_half_up(x), 0, 255) / 255.0
    mean = torch.tensor(IMAGENET_MEAN, device=frames.device)
    std = torch.tensor(IMAGENET_STD, device=frames.device)
    return (x - mean) / std


def postprocess(logp):
    """(T, H, W) log-probabilities -> uint8 maps: ``exp``, divide by the
    frame's max, times 255, truncated."""
    p = torch.exp(logp.to(torch.float32))
    m = torch.amax(p, dim=(1, 2), keepdim=True)
    return (torch.where(m > 0, p / m, p) * 255.0).to(torch.uint8)


def sample_frames(probs, skip: int, n: int):
    """The sequential selection rule: frame f is picked when it is
    ``skip`` after the last pick, follows a frame whose transition
    probability exceeds the threshold, is the first or the last frame.
    Returns (picks, map2orig)."""
    picks, map2orig = [], []
    for f in range(n):
        want = (f == picks[-1] + skip) if picks else True
        after_cut = f > 0 and bool(probs[f - 1] > TRANS_THRESHOLD)
        if want or after_cut or f == n - 1:
            picks.append(f)
        map2orig.append(len(picks) - 1)
    return picks, map2orig


def scenes(probs, n: int) -> np.ndarray:
    """[start, end] spans of below-threshold runs (one full-length scene
    when none), each end stretched to the next start, the last to n-1."""
    preds = (np.asarray(probs) > TRANS_THRESHOLD).astype(np.uint8)
    out = []
    t, t_prev, start = -1, 0, 0
    for i, t in enumerate(preds):
        if t_prev == 1 and t == 0:
            start = i
        if t_prev == 0 and t == 1 and i != 0:
            out.append([start, i])
        t_prev = t
    if t == 0:
        out.append([start, i])
    if not out:
        out = [[0, len(preds) - 1]]
    seg = np.array(out, np.int64)
    seg[:-1, 1] = seg[1:, 0] - 1
    seg[-1, 1] = n - 1
    return seg


@torch.no_grad()
def shots(tn, raw, crop_params: dict, keep: int = 25) -> dict:
    """The clip's ingest, TransNet and host sampling and scenes: ``probs``
    (fc,), ``picks``, ``seg`` and ``seg_sel`` (segments, 2) and the
    saliency-resolution frames ``sal_frames`` (fc, sal_h, sal_w, 3)."""
    fc, h, w = (int(s) for s in raw.shape[:3])
    sal_hw = sal_dims(w, h, crop_params['max_input_d'])
    tn_frames = to_u8(resize(raw, (27, 48), 'linear', channels_last=True))
    sal_frames = to_u8(resize(raw, sal_hw, 'linear', channels_last=True))
    probs = fullseq_forward(tn, tn_frames, fc, fc, keep=(keep, 3 * keep))
    probs = probs.float().cpu().numpy()
    picks, map2orig = sample_frames(probs, int(crop_params['skip']), fc)
    seg = scenes(probs, fc)
    return {'probs': probs, 'picks': picks, 'seg': seg,
            'seg_sel': np.asarray(map2orig)[seg], 'sal_frames': sal_frames}


@torch.no_grad()
def saliency_maps(un, sal_frames, picks, *, input_dtype=torch.bfloat16,
                  source: str = 'SALICON'):
    """UNISAL's static forward on the picks and the postprocess: (picks,
    sal_h, sal_w) uint8 maps.  The input is rounded to ``input_dtype``
    first, as the configuration states."""
    sal_hw = tuple(sal_frames.shape[1:3])
    x = preprocess(sal_frames[torch.as_tensor(picks, device=sal_frames.device)],
                   net_size(sal_hw)).to(input_dtype)
    logp, _ = un(x[:, None], target_size=sal_hw, source=source)
    return postprocess(logp[:, 0, :, :, 0].float())


@torch.no_grad()
def geometry(maps, shot: dict, crop_params: dict, *, fps: float, ratios,
             h: int, w: int) -> dict:
    """The geometry chain over the picks' uint8 maps: the reference
    ingest's zeroed last map, borders, mean saliency, the series and one
    box tail per ratio.  ``mean_sal`` (over the picks padded to their
    bucket), ``dx``/``dy`` (picks,), ``dxs``/``dys`` (fc,), ``boxes``
    (ratios, fc, 4)."""
    fc = len(shot['probs'])
    picks, seg = shot['picks'], shot['seg']
    sel_mask, ti, seg_cols = pad_clip_tables(picks, seg, shot['seg_sel'])
    t_sel, t_pad = len(picks), len(ti)
    dev = maps.device
    smaps = torch.zeros((t_pad,) + tuple(maps.shape[1:]), device=dev)
    smaps[:t_sel] = maps[:t_sel].to(torch.float32)
    smaps[t_sel - 1] = 0                 # the reference ingest's last map
    sal_h, sal_w = smaps.shape[1:]
    cfg = GeometryConfig.from_crop_params(crop_params)
    borders = border_detection(smaps, crop_params['t_border'], h, w)
    mean_sal, _ = mean_saliency(smaps)

    def tensor(a):
        return torch.as_tensor(np.asarray(a), device=dev)

    series = geometry_series(
        smaps, tensor(sel_mask), t_sel, tensor(ti),
        *(tensor(c) for c in seg_cols), len(seg), cfg=cfg, fps=float(fps),
        t_out=bucket_size(fc))
    boxes = []
    for ratio in ratios:
        wf, hf = dest_size(w, h, ratio)
        tail = geometry_boxes(
            series, borders['border_t'], borders['border_b'],
            borders['border_l'], borders['border_r'], h_orig=h, w_orig=w,
            h_process=sal_h, w_process=sal_w, w_final=wf, h_final=hf,
            shift=cfg.shift_time)
        boxes.append(tail['boxes'][:fc].cpu().numpy())
    return {
        'mean_sal': float(mean_sal),
        'dx': series['dx'][:t_sel].cpu().numpy(),
        'dy': series['dy'][:t_sel].cpu().numpy(),
        'dxs': series['dxs'][:fc].cpu().numpy(),
        'dys': series['dys'][:fc].cpu().numpy(),
        'boxes': np.stack(boxes),
    }


@torch.no_grad()
def crop_clip(tn, un, raw, crop_params: dict, *, fps: float, ratios,
              un_input_dtype=torch.bfloat16, source: str = 'SALICON') -> dict:
    """(fc, H, W, 3) uint8 clip -> every stage's outputs: :func:`shots`',
    the picks' ``maps`` and :func:`geometry`'s."""
    fc, h, w = (int(s) for s in raw.shape[:3])
    shot = shots(tn, raw, crop_params)
    maps = saliency_maps(un, shot['sal_frames'], shot['picks'],
                         input_dtype=un_input_dtype, source=source)
    seg = shot['seg']
    return {**shot, 'maps': maps, 'fc_sel': len(shot['picks']),
            'n_segments': len(seg), 'sel_idx': np.asarray(shot['picks']),
            'seg_starts': seg[:, 0], 'seg_ends': seg[:, 1],
            **geometry(maps, shot, crop_params, fps=fps, ratios=ratios,
                       h=h, w=w)}


@torch.no_grad()
def saliency_video(un, frames, *, source: str = 'DHF1K',
                   frame_modulo: int = 4, seq_len: int = 6,
                   dtype=torch.float32) -> np.ndarray:
    """(T, H, W, 3) uint8 -> (T, H, W) uint8 maps, UNISAL's dynamic mode
    computing in its parameters' dtype, the input cast to ``dtype``."""
    t, h, w, _ = frames.shape
    net_hw = net_size((h, w))
    logps = torch.empty((t, h, w), dtype=torch.float32, device=frames.device)
    for offset in range(min(frame_modulo, t)):
        seq = frames[offset::frame_modulo]
        h0 = None
        for s in range(0, len(seq), seq_len):
            batch = seq[s:s + seq_len]
            n = len(batch)
            if n < seq_len:
                batch = torch.cat([batch, batch[-1:].expand(
                    seq_len - n, -1, -1, -1)])
            x = preprocess(batch, net_hw).to(dtype)
            logp, h0 = un(x[None], target_size=(h, w), source=source,
                          h0=h0, static=False)
            idx = torch.arange(offset + s * frame_modulo, t, frame_modulo,
                               device=frames.device)[:n]
            logps[idx] = logp[0, :n, :, :, 0].float()
    return postprocess(logps).cpu().numpy()
