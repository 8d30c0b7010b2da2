"""Entry path: ``OneShotClipProgram`` of ``retargetvid_tpu_torch`` (one
program per clip: ingest resizes, TransNet, sampling and scenes on the
device, UNISAL, the postprocess kernel, the geometry chain), one ratio
through ``dispatch``/``collect`` (what ``run`` does) or several through
``dispatch_multi``/``collect_multi``.

The check: for each sampled pool clip, every output the window produced
against the plain reference (``portbench/reference/pipeline.py:crop_clip``)
in float32 with TF32 off, on the same clip and weights.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import inputs
from portbench.check import MAP_GAPS, map_gaps, run_check, tf32
from portbench.counts import bytes as kbytes
from portbench.counts import flops
from portbench.reference import pipeline as ref
from portbench.reference.transnet import TransNetV1 as RefTransNet
from portbench.reference.unisal import UNISAL as RefUNISAL

_DTYPES = {'bfloat16': torch.bfloat16, 'float32': torch.float32}


def tn_kwargs(cfg):
    t = cfg['transnet']
    return dict(f=t['F'], l=t['L'], s=t['S'], d=t['D'])


def ref_models(cfg, tn_state, un_state, device, tn_dtype=torch.float32,
               un_dtype=torch.float32):
    tn = RefTransNet(**tn_kwargs(cfg))
    tn.load_state_dict(tn_state)
    un = RefUNISAL(cnn_widen_factor=cfg['unisal']['cnn_widen_factor'])
    un.load_state_dict(un_state)
    return (tn.to(device, tn_dtype).eval(), un.to(device, un_dtype).eval())


def fp8_emulate_(model: torch.nn.Module) -> torch.nn.Module:
    """Round every conv and dense layer's weight and input to float8 e4m3
    (one scale per tensor, its max over 448); the arithmetic and each
    layer's output stay in the model's dtype.  The control's precision for
    a bf16 model."""
    def q(t):
        f = t.detach().float()
        s = f.abs().amax().clamp(min=1e-12) / 448.0
        return ((f / s).to(torch.float8_e4m3fn).float() * s).to(t.dtype)

    def hook(mod, args):
        return (q(args[0]),) + tuple(args[1:])

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.Conv3d, torch.nn.Linear)):
                m.weight.copy_(q(m.weight))
                m.register_forward_pre_hook(hook)
    return model


GEOMETRY_KEYS = ('boxes', 'dx', 'dy', 'dxs', 'dys')


def normalize(outs: list, maps, fc: int) -> dict:
    """The program's per-ratio output dicts and its kernel's maps in the
    reference's form."""
    o = outs[0]
    t_sel, n_seg = int(o['fc_sel']), int(o['n_segments'])
    return {
        'fc_sel': t_sel, 'n_segments': n_seg,
        'sel_idx': np.asarray(o['sel_idx'][:t_sel]).astype(np.int64),
        'seg_starts': np.asarray(o['seg_starts'][:n_seg]).astype(np.int64),
        'seg_ends': np.asarray(o['seg_ends'][:n_seg]).astype(np.int64),
        'maps': maps[:t_sel],
        'mean_sal': float(o['mean_sal']),
        'dx': np.asarray(o['dx'][:t_sel]), 'dy': np.asarray(o['dy'][:t_sel]),
        'dxs': np.asarray(o['dxs'][:fc]), 'dys': np.asarray(o['dys'][:fc]),
        'boxes': np.stack([np.asarray(x['boxes'][:fc]) for x in outs]),
    }


class Adapter:
    """The cell's program, built from the seed, and its check."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        from retargetvid_tpu_torch.models.transnet import TransNetV1
        from retargetvid_tpu_torch.models.unisal import UNISAL
        from retargetvid_tpu_torch.pipeline.oneshot import OneShotClipProgram
        self.cfg, self.seed = cfg, seed
        self.device = device
        t, u = cfg['transnet'], cfg['unisal']
        if u['input_dtype'] != t['dtype']:
            raise ValueError('OneShotClipProgram feeds UNISAL in the '
                             'TransNet dtype; the configuration asks '
                             'for two')
        with torch.device(device):
            tn = TransNetV1(**tn_kwargs(cfg))
            un = UNISAL(cnn_widen_factor=u['cnn_widen_factor'])
        tn, un = tn.to(device), un.to(device)
        inputs.seed_weights_(tn, seed, 1, device,
                             {'dense2': t.get('head_bias', [0.0, 0.0])})
        inputs.seed_weights_(un, seed, 2, device)
        self.tn_state, self.un_state = inputs.state_of(tn), inputs.state_of(un)
        self.program = OneShotClipProgram(
            tn, un, source=u['source'], dtype=_DTYPES[t['dtype']],
            tn_fullseq=t['plan'] == 'fullseq', device=device)
        self.cp = dict(cfg['crop_params'])
        self.ratios = list(traffic['ratios'])
        self.fc = int(traffic['frames'])
        self.h, self.w = int(traffic['height']), int(traffic['width'])
        self.fps = float(traffic['fps'])
        self.dests = [ref.dest_size(self.w, self.h, r) for r in self.ratios]
        self.frames_per_clip = self.fc
        self.last_fc_sel = None
        self._geometry = {}
        # The kernel's uint8 maps of each clip, held until it is collected
        # (the program returns no maps): what the check compares UNISAL by.
        from retargetvid_tpu_torch.pipeline import fused
        self._fused, self._kernel = fused, fused.saliency_postprocess

        def kernel(logp):
            self._maps = self._kernel(logp)
            return self._maps
        fused.saliency_postprocess = kernel

    def make_pool(self, n: int) -> list:
        return inputs.clip_pool(n, self.fc, self.h, self.w, self.seed,
                                self.device)

    def make_timer(self):
        from retargetvid_tpu_torch.pipeline.oneshot import StageTimer
        return StageTimer()

    def set_timer(self, timer) -> None:
        self.program.timer = timer

    def dispatch(self, clip):
        if len(self.dests) == 1:
            wf, hf = self.dests[0]
            ticket = self.program.dispatch(clip, self.cp, fps=self.fps,
                                           w_final=wf, h_final=hf)
        else:
            ticket = self.program.dispatch_multi(clip, self.cp, fps=self.fps,
                                                 dests=self.dests)
        return ticket, self._maps

    def collect(self, ticket):
        ticket, maps = ticket
        if len(self.dests) == 1:
            outs = [self.program.collect(ticket)]
        else:
            outs = self.program.collect_multi(ticket)
        self.last_fc_sel = int(outs[0]['fc_sel'])
        return outs, maps

    def counts(self) -> dict:
        """The traced run's live sizes: model FLOPs with their dtypes, the
        postprocess kernel's bytes."""
        tn, un = ref_models(self.cfg, self.tn_state, self.un_state, 'cpu')
        sal_hw = ref.sal_dims(self.w, self.h, self.cp['max_input_d'])
        picks = self.last_fc_sel
        return {
            'model_flops': [
                (flops.transnet_fullseq(tn, self.fc),
                 self.cfg['transnet']['dtype']),
                (flops.unisal_static(un, picks, ref.net_size(sal_hw),
                                     sal_hw),
                 self.cfg['unisal']['conv_precision'])],
            'postprocess_bytes': kbytes.postprocess_bytes(picks, *sal_hw),
        }

    def release(self) -> None:
        self.program = None
        self._fused.saliency_postprocess = self._kernel

    def reference(self, clip, control: bool = False) -> dict:
        """The reference's outputs of a clip in float32, with the picks'
        maps again under TF32 convolutions (``maps_tf32``); with
        ``control``, the control's: TransNet's conv and dense inputs and
        weights in float8 around bf16 arithmetic, UNISAL in bf16."""
        low = torch.bfloat16 if control else torch.float32
        tn, un = ref_models(self.cfg, self.tn_state, self.un_state,
                            clip.device, tn_dtype=low, un_dtype=low)
        if control:
            fp8_emulate_(tn)
        u = self.cfg['unisal']
        out = ref.crop_clip(tn, un, clip, self.cp, fps=self.fps,
                            ratios=self.ratios,
                            un_input_dtype=_DTYPES[u['input_dtype']],
                            source=u['source'])
        sal = out.pop('sal_frames')
        if not control:
            with tf32(True):
                out['maps_tf32'] = ref.saliency_maps(
                    un, sal, out['picks'],
                    input_dtype=_DTYPES[u['input_dtype']],
                    source=u['source'])
        return out

    def check(self, outputs: dict, clips: list, control: bool = False):
        """The worst of each number over every sampled output, each with
        its limit; with ``control`` also the control's numbers."""
        return run_check(self, outputs, clips, control)

    def normalize(self, out) -> dict:
        outs, maps = out
        return normalize(outs, maps, self.fc)

    def compare(self, got: dict, expect: dict) -> dict:
        """The numbers of ``got`` (the program's outputs, or the
        control's) against ``expect`` (the reference's, from the clip):

        - ``scene_mismatch``: sampled frames, their count, the scene
          count and bounds that differ (TransNet, sampling, scenes);
        - ``map_mean_gap``: the picks' uint8 maps, mean gap in steps
          (UNISAL and the postprocess kernel);
        - ``geometry_mismatch``: the reference geometry run on ``got``'s
          own maps; the boxes of every ratio, centres, smoothed series
          and the mean saliency that differ from ``got``'s (the geometry
          chain, followed step by step from the program's maps).
        """
        inf = float('inf')
        same = (got['fc_sel'] == expect['fc_sel']
                and got['n_segments'] == expect['n_segments'])
        if not same:
            return {'scene_mismatch': 1.0 + abs(got['fc_sel']
                                                - expect['fc_sel']),
                    **{k: inf for k in MAP_GAPS}, 'geometry_mismatch': inf}
        scene = sum(int(np.sum(got[k] != expect[k]))
                    for k in ('sel_idx', 'seg_starts', 'seg_ends'))
        geo = self._reference_geometry(got['maps'], expect)
        wrong = sum(int(np.sum(np.asarray(got[k]) != geo[k]))
                    for k in GEOMETRY_KEYS)
        wrong += int(got['mean_sal'] != geo['mean_sal'])
        return {'scene_mismatch': float(scene),
                **map_gaps(got['maps'], expect),
                'geometry_mismatch': float(wrong)}

    def _reference_geometry(self, maps, shot: dict) -> dict:
        key = (hash(maps.cpu().numpy().tobytes()), tuple(shot['picks']))
        if key not in self._geometry:
            self._geometry[key] = ref.geometry(
                maps, shot, self.cp, fps=self.fps, ratios=self.ratios,
                h=self.h, w=self.w)
        return self._geometry[key]
