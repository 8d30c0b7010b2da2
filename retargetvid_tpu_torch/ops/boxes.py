"""Destination size and crop boxes.

Port of ``retargetvid_tpu/ops/boxes.py:calc_dest_size, compute_crop_boxes,
shift_time`` (reference ``sc_calc_dest_size``, ``smartVidCrop.py:946-977``,
``sc_compute_bb``, ``:979-1048``, and ``sc_shift_time``, ``:1740-1746``):
the per-frame clamping loop is one elementwise pass over the center series.
"""

from __future__ import annotations

import math

import torch

from retargetvid_tpu_torch.utils import timing

__all__ = ["calc_dest_size", "compute_crop_boxes", "shift_time"]


def calc_dest_size(w_orig: int, h_orig: int, out_ratio: str) -> dict:
    """Final crop-window dims and conversion mode (0: none, 1: preserve
    height, 2: preserve width)."""
    c = out_ratio.split(':')
    target_w_units = float(c[0])
    target_h_units = float(c[1])
    orig_ratio = float(w_orig) / float(h_orig)
    target_ratio = target_w_units / target_h_units

    if abs(orig_ratio - target_ratio) < 1e-7:
        return {'w_final': w_orig, 'h_final': h_orig, 'conversion_mode': 0}

    w_final = int(math.floor((target_w_units / target_h_units) * h_orig))
    h_final = h_orig
    mode = 1
    if w_final > w_orig or h_final > h_orig:
        w_final = w_orig
        h_final = int(math.floor((target_h_units / target_w_units) * w_orig))
        mode = 2
    return {'w_final': w_final, 'h_final': h_final, 'conversion_mode': mode}


def _i32(v, device):
    if not torch.is_tensor(v):
        timing.count('dispatch_syncs')      # an upload from the host
    return torch.as_tensor(v, dtype=torch.int32, device=device)


def compute_crop_boxes(dxs: torch.Tensor, dys: torch.Tensor, *,
                       w_orig: int, h_orig: int,
                       w_process: int, h_process: int,
                       w_final: int, h_final: int,
                       border_t=0, border_b=0, border_l=0, border_r=0):
    """Per-frame [x1, y1, x2, y2] int32 boxes plus (fbb_w, fbb_h).

    Centers scale to the original resolution with int truncation; the final
    window shrinks by the detected borders; the window splits around the
    center with floor/remainder halves and is clamped left/top first, then
    right/bottom.
    """
    dev = dxs.device
    scale_h = float(h_process) / float(h_orig)
    scale_w = float(w_process) / float(w_orig)
    final_xs = torch.floor(dxs.to(torch.float32) / scale_w).to(torch.int32)
    final_ys = torch.floor(dys.to(torch.float32) / scale_h).to(torch.int32)

    bt, bb = _i32(border_t, dev), _i32(border_b, dev)
    bl, br = _i32(border_l, dev), _i32(border_r, dev)
    wf, hf = _i32(w_final, dev), _i32(h_final, dev)
    wf_f, hf_f = wf.to(torch.float32), hf.to(torch.float32)

    cond_h = hf == h_orig
    fbb_h_v = hf - bt - bb
    fbb_w_v = (fbb_h_v.to(torch.float32) / hf_f * wf_f).to(torch.int32)
    cond_w = wf == w_orig
    fbb_w_h = wf - bl - br
    fbb_h_h = (fbb_w_h.to(torch.float32) / wf_f * hf_f).to(torch.int32)
    # The height branch applies first; the width branch overrides it.
    fbb_w = torch.where(cond_w, fbb_w_h, torch.where(cond_h, fbb_w_v, wf))
    fbb_h = torch.where(cond_w, fbb_h_h, torch.where(cond_h, fbb_h_v, hf))

    hbbw1 = (fbb_w.to(torch.float32) / 2.0).to(torch.int32)
    hbbw2 = fbb_w - hbbw1
    hbbh1 = (fbb_h.to(torch.float32) / 2.0).to(torch.int32)
    hbbh2 = fbb_h - hbbh1

    x1 = final_xs - hbbw1
    y1 = final_ys - hbbh1
    x2 = final_xs + hbbw2
    y2 = final_ys + hbbh2

    x2 = torch.where(x1 < bl, bl + fbb_w, x2)
    x1 = torch.where(x1 < bl, bl, x1)
    over_r = x2 > (w_orig - br)
    x1 = torch.where(over_r, w_orig - br - fbb_w, x1)
    x2 = torch.where(over_r, w_orig - br, x2)

    y2 = torch.where(y1 < bt, bt + fbb_h, y2)
    y1 = torch.where(y1 < bt, bt, y1)
    over_b = y2 > (h_orig - bb)
    y1 = torch.where(over_b, h_orig - bb - fbb_h, y1)
    y2 = torch.where(over_b, h_orig - bb, y2)

    boxes = torch.stack([x1, y1, x2, y2], dim=1).to(torch.int32)
    return boxes, fbb_w, fbb_h


def shift_time(boxes: torch.Tensor, shift: int) -> torch.Tensor:
    """Shift the (T, 4) boxes ``shift`` frames earlier: rows [shift:] move
    to [0:T-shift] and the last ``shift`` rows repeat row T-1."""
    if shift <= 0:
        return boxes
    t = boxes.shape[0]
    idx = torch.clamp(torch.arange(t, device=boxes.device) + shift,
                      max=t - 1)
    return boxes[idx]
