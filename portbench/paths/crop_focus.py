"""Entry path: ``crop_oneshot``'s ``OneShotClipProgram`` on clips whose
subject jumps away and back, with UNISAL's seeded maps given structure, so
that the geometry chain's focus scores and freeze have something to act on.

- **Clips** (:func:`clip_pool`): the formula of ``inputs.clip_pool`` on
  the same noise draws; over the traffic's ``jump`` frames ``[a, b)`` the
  blob's centre moves right by ``shift`` of the width.  Outside them every
  frame equals ``inputs.clip_pool``'s bit for bit.
- **Weights**: seeded as ``crop_oneshot`` seeds them, except the 1x1
  adaptation conv's weight (its bias is zero), which the head rule sets
  at set-up (:meth:`Adapter._set_head`).  Seeded UNISAL's maps barely
  depend on the clip: their log-softmax spreads by a few hundredths
  within a frame, so the uint8 maps lie nearly all above a threshold of
  90, and on most seeds their peak does not follow the subject.  The rule
  runs the float32 reference UNISAL (TF32 off) on :data:`HEAD_FRAMES`
  frames of the first pool clip: the weight's direction is Fisher's
  discriminant of the features at the blob's centre against the frame
  (:func:`head_direction`), and its scale leaves at most the
  configuration's ``unisal.salient_share`` of any of those frames' pixels
  above ``t_threshold`` (:func:`head_scale`; everything after the conv up
  to the log-softmax is linear).  The reference and the control load the
  same weight.

The check: ``crop_oneshot``'s numbers, with ``geometry_mismatch`` also
counting each pick's focus score (``jumps``) that differs from the one the
reference geometry gives the program's own maps; beside them
``no_freeze``: 1 where the program's focus scores freeze no span on a
checked clip (the freeze itself is judged through the centres).
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from portbench import inputs
from portbench.check import tf32
from portbench.paths import crop_oneshot
from portbench.reference import pipeline as ref
from portbench.reference.geometry import (
    GeometryConfig,
    bucket_size,
    geometry_series,
    pad_clip_tables,
)
from portbench.reference.temporal import frozen_spans

_DTYPES = crop_oneshot._DTYPES
#: Frames of the first pool clip, evenly spaced, that the head rule reads:
#: one forward, under the program's own peak of device memory.
HEAD_FRAMES = 27


def blob_centres(frames: int, h: int, w: int, device,
                 jump: dict | None = None):
    """The blob's (x, y) centre in each frame, (frames,) float32 each:
    ``inputs.clip_pool``'s path, moved right by ``jump['shift']`` of the
    width over the frames ``jump['frames']`` (``[a, b)``)."""
    t = torch.arange(frames, device=device, dtype=torch.float32)
    lin = t / max(frames - 1, 1)
    cx = w * (0.2 + 0.6 * lin)
    if jump:
        a, b = (int(f) for f in jump['frames'])
        cx = torch.where((t >= a) & (t < b), cx + float(jump['shift']) * w,
                         cx)
    cy = h * (0.5 + 0.2 * torch.sin(8.0 * lin))
    return cx, cy


@torch.no_grad()
def clip_pool(n_clips: int, frames: int, h: int, w: int, seed: int, device,
              jump: dict | None = None) -> list:
    """``inputs.clip_pool`` with the blob on :func:`blob_centres`' path;
    without ``jump``, ``inputs.clip_pool``'s clips."""
    gen = torch.Generator(device=device).manual_seed(inputs._mix(seed, 7))
    cx, cy = blob_centres(frames, h, w, device, jump)
    yy = torch.arange(h, device=device, dtype=torch.float32)
    xx = torch.arange(w, device=device, dtype=torch.float32)
    dy2 = (yy[None, :] - cy[:, None]) ** 2                  # (T, h)
    dx2 = (xx[None, :] - cx[:, None]) ** 2                  # (T, w)
    blob = 200.0 * torch.exp(-(dy2[:, :, None] + dx2[:, None, :]) / 2500.0)
    pool = []
    for _ in range(n_clips):
        base = torch.randint(0, 60, (h, w, 3), generator=gen, device=device)
        clip = torch.clamp(base.to(torch.float32)[None]
                           + blob[..., None], 0, 255)
        pool.append(clip.to(torch.uint8))
    return pool


@torch.no_grad()
def head_inputs(un, clip, max_input_d: int, *, input_dtype=torch.bfloat16,
                source: str = 'SALICON'):
    """On :data:`HEAD_FRAMES` evenly spaced frames of ``clip`` (the
    reference's ingest resize, preprocess and static forward): the
    features that enter the adaptation conv, (HEAD_FRAMES, C, h, w), and
    UNISAL's log-softmax output, (HEAD_FRAMES, sal_h, sal_w), both float64,
    and the frames' indices."""
    fc, h, w = (int(s) for s in clip.shape[:3])
    idx = torch.linspace(0, fc - 1, HEAD_FRAMES,
                         device=clip.device).round().long()
    sal_hw = ref.sal_dims(w, h, max_input_d)
    frames = ref.to_u8(ref.resize(clip[idx], sal_hw, 'linear',
                                  channels_last=True))
    x = ref.preprocess(frames, ref.net_size(sal_hw))
    feats = []
    conv = getattr(un, f'adaptation_{source.lower()}')
    hook = conv.register_forward_pre_hook(
        lambda mod, args: feats.append(args[0].double()))
    try:
        logp, _ = un(x.to(input_dtype)[:, None], target_size=sal_hw,
                     source=source)
    finally:
        hook.remove()
    return feats[0], logp[:, 0, :, :, 0].double(), idx


def head_direction(feats, idx, clip_hw, jump: dict | None = None):
    """The adaptation weight's direction, (C,) float64: Fisher's
    discriminant of the blob's centre against the frame, that is the
    features' covariance over every pixel of the frames (each frame less
    its mean; a ridge of a thousandth of the mean variance) solved against
    the mean over the frames of the features at the blob's centre less
    their mean over the frame."""
    n, c, fh, fw = feats.shape
    h, w = clip_hw
    cx, cy = blob_centres(int(idx[-1]) + 1, h, w, feats.device, jump)
    col = (cx[idx] * (fw / w)).long().clamp(0, fw - 1)
    row = (cy[idx] * (fh / h)).long().clamp(0, fh - 1)
    centred = feats - feats.mean(dim=(2, 3), keepdim=True)
    at = centred[torch.arange(n, device=feats.device), :, row, col]
    x = centred.permute(0, 2, 3, 1).reshape(-1, c)
    cov = x.T @ x / x.shape[0]
    ridge = 1e-3 * torch.diagonal(cov).mean()
    eye = torch.eye(c, dtype=cov.dtype, device=cov.device)
    return torch.linalg.solve(cov + ridge * eye, at.mean(dim=0))


def head_scale(logp, share: float, t_threshold: float) -> float:
    """The least factor that leaves at most ``share`` of any frame's
    pixels above ``t_threshold`` of 255 on the uint8 map, for UNISAL's
    log-softmax output ``logp`` at the weight's present scale: a pixel
    lies above it where its gap below the frame's peak log-probability,
    times the factor, is under ``log(255 / t_threshold)``."""
    gap = (logp.flatten(1).amax(dim=1, keepdim=True) - logp.flatten(1))
    at_share = torch.quantile(gap, share, dim=1)
    return float((np.log(255.0 / t_threshold) / at_share).max())


def reference_jumps(maps, shot: dict, crop_params: dict, *,
                    fps: float) -> np.ndarray:
    """The reference geometry's focus scores over the picks' uint8 maps,
    (picks,) float32: ``ref.geometry``'s series on the same padded maps
    and tables."""
    picks, seg = shot['picks'], shot['seg']
    sel_mask, ti, seg_cols = pad_clip_tables(picks, seg, shot['seg_sel'])
    t_sel, dev = len(picks), maps.device
    smaps = torch.zeros((len(ti),) + tuple(maps.shape[1:]), device=dev)
    smaps[:t_sel] = maps[:t_sel].to(torch.float32)
    smaps[t_sel - 1] = 0                 # the reference ingest's last map

    def tensor(a):
        return torch.as_tensor(np.asarray(a), device=dev)

    series = geometry_series(
        smaps, tensor(sel_mask), t_sel, tensor(ti),
        *(tensor(c) for c in seg_cols), len(seg),
        cfg=GeometryConfig.from_crop_params(crop_params), fps=float(fps),
        t_out=bucket_size(len(shot['probs'])))
    return series['jumps'][:t_sel].cpu().numpy()


class Adapter(crop_oneshot.Adapter):
    """The cell's program, built from the seed with the head rule applied,
    and its check."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        super().__init__(cfg, traffic, seed, device)
        self.jump = traffic.get('jump')
        self._jumps = {}
        self.head = self._set_head(float(cfg['unisal']['salient_share']))

    def make_pool(self, n: int) -> list:
        return clip_pool(n, self.fc, self.h, self.w, self.seed, self.device,
                         self.jump)

    def _set_head(self, share: float):
        """Set the program's adaptation weight by the head rule on the
        first pool clip; the reference's state is taken again after it."""
        t0 = time.perf_counter()
        u = self.cfg['unisal']
        clip = self.make_pool(1)[0]
        un = crop_oneshot.RefUNISAL(cnn_widen_factor=u['cnn_widen_factor'])
        un.load_state_dict(self.un_state)
        un = un.to(self.device).eval()
        conv = getattr(un, f'adaptation_{u["source"].lower()}')

        def forward():
            with tf32(False):
                return head_inputs(un, clip, self.cp['max_input_d'],
                                   input_dtype=_DTYPES[u['input_dtype']],
                                   source=u['source'])
        feats, _, idx = forward()
        direction = head_direction(feats, idx, (self.h, self.w), self.jump)
        with torch.no_grad():
            conv.weight.copy_(direction.view_as(conv.weight))
        weight = direction * head_scale(forward()[1], share,
                                        float(self.cp['t_threshold']))
        del un, feats, clip
        conv = getattr(self.program.un_model,
                       f'adaptation_{u["source"].lower()}')
        with torch.no_grad():
            conv.weight.copy_(weight.view_as(conv.weight))
        self.un_state = inputs.state_of(self.program.un_model)
        print(f'crop_focus: head norm {float(weight.norm())!r} '
              f'({time.perf_counter() - t0:.3f} s)', file=sys.stderr)
        return weight

    def normalize(self, out) -> dict:
        got = super().normalize(out)
        outs, _ = out
        got['jumps'] = np.asarray(outs[0]['jumps'][:got['fc_sel']])
        return got

    def compare(self, got: dict, expect: dict) -> dict:
        """``crop_oneshot``'s numbers, the focus scores that differ added
        to ``geometry_mismatch``, and ``no_freeze``: 1 where ``got``'s
        scores freeze no span.  The control's outputs are the reference
        geometry's own and carry no scores: the reference's scores on its
        maps stand for them."""
        out = super().compare(got, expect)
        if np.isinf(out['geometry_mismatch']):
            return {**out, 'no_freeze': 1.0}
        key = (hash(got['maps'].cpu().numpy().tobytes()),
               tuple(expect['picks']))
        if key not in self._jumps:
            self._jumps[key] = reference_jumps(got['maps'], expect, self.cp,
                                               fps=self.fps)
        jumps = self._jumps[key]
        own = got.get('jumps', jumps)
        out['geometry_mismatch'] += float(np.sum(own != jumps))
        spans = frozen_spans(
            np.flatnonzero(own < self.cp['foces_stab_t']).tolist(),
            fc_sel=len(jumps), skip=int(self.cp['skip']), fps=self.fps,
            stab_secs=float(self.cp['foces_stab_s']))
        return {**out, 'no_freeze': float(not spans)}
