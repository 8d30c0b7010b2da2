"""Entry path: ``OneShotClipProgram`` of ``retargetvid_tpu_torch`` with
TransNet V2 (``models/transnetv2.py``) as its shot detector, in the 100/50
window plan, one ratio per clip; everything after the shot detector is
``crop_oneshot``'s path, and so are the pool, the timer and the
dispatch.

The check: ``crop_oneshot``'s numbers against the plain reference with V2
(``portbench/reference/pipeline_transnetv2.py``), and the one-hot head's
logits over every frame of the clip, which random weights would otherwise
leave unjudged (the head's bias decides the cuts):

- ``shot_logit_gap``: mean |program logit - float32 reference logit|;
- ``shot_logit_bf16_gap``: the same gap of the reference computed in bf16
  with TF32 off, and ``shot_logit_gap_ratio``, the first over the second.

A program without TransNet V2 ends the run at once without a result.
"""

from __future__ import annotations

import torch

from portbench import core, inputs
from portbench.check import tf32
from portbench.counts import bytes as kbytes
from portbench.counts import flops
from portbench.counts import transnetv2 as v2_flops
from portbench.paths import crop_oneshot
from portbench.reference import pipeline as ref
from portbench.reference import pipeline_transnetv2 as ref_v2
from portbench.reference.transnetv2 import TransNetV2 as RefTransNetV2
from portbench.reference.transnetv2 import predict_frames
from portbench.reference.unisal import UNISAL as RefUNISAL

_DTYPES = crop_oneshot._DTYPES
LOGIT_GAPS = ('shot_logit_gap', 'shot_logit_bf16_gap', 'shot_logit_gap_ratio')


def tn_kwargs(cfg):
    t = cfg['transnet']
    return dict(F=t['F'], L=t['L'], S=t['S'], D=t['D'])


def ref_models(cfg, tn_state, un_state, device, tn_dtype=torch.float32,
               un_dtype=torch.float32):
    tn = RefTransNetV2(**tn_kwargs(cfg))
    tn.load_state_dict(tn_state)
    un = RefUNISAL(cnn_widen_factor=cfg['unisal']['cnn_widen_factor'])
    un.load_state_dict(un_state)
    return (tn.to(device, tn_dtype).eval(), un.to(device, un_dtype).eval())


def logit_gaps(got, expect: dict) -> dict:
    """Mean gaps of the one-hot logits (fc,) from the float32 reference's
    (``expect['logits']``), the bf16 reference's gap and their ratio (the
    gap of the seeded weights moves from seed to seed; the ratio does
    not)."""
    ref_logits = expect['logits'].double()
    gap = (got.to(ref_logits.device).double() - ref_logits).abs().mean()
    base = (expect['logits_bf16'].double() - ref_logits).abs().mean()
    return {'shot_logit_gap': float(gap), 'shot_logit_bf16_gap': float(base),
            'shot_logit_gap_ratio': float(gap / max(float(base), 1e-30))}


class Adapter(crop_oneshot.Adapter):
    """The cell's program, built from the seed, and its check."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        try:
            from retargetvid_tpu_torch.models.transnetv2 import (
                LOOKUP_WINDOW,
                TransNetV2,
            )
        except ImportError as e:
            raise core.NoResult(f'the program has no TransNet V2 ({e})')
        from retargetvid_tpu_torch.models.unisal import UNISAL
        from retargetvid_tpu_torch.pipeline import fused
        from retargetvid_tpu_torch.pipeline.oneshot import OneShotClipProgram
        self.cfg, self.seed, self.device = cfg, seed, device
        t, u = cfg['transnet'], cfg['unisal']
        if (t['plan'] != 'window' or t['threshold'] != TransNetV2.threshold
                or t['lookup_window'] != LOOKUP_WINDOW):
            raise ValueError('the configuration asks for a TransNet V2 '
                             'plan, threshold or band the program does '
                             'not run')
        if u['input_dtype'] != t['dtype']:
            raise ValueError('OneShotClipProgram feeds UNISAL in the '
                             'TransNet dtype; the configuration asks '
                             'for two')
        with torch.device(device):
            tn = TransNetV2(**tn_kwargs(cfg))
            un = UNISAL(cnn_widen_factor=u['cnn_widen_factor'])
        tn, un = tn.to(device), un.to(device)
        inputs.seed_weights_(tn, seed, 1, device,
                             {'cls_layer1': t['head_bias']})
        inputs.seed_weights_(un, seed, 2, device)
        self.tn_state, self.un_state = inputs.state_of(tn), inputs.state_of(un)
        self.keep = tuple(t['keep'])
        self.program = OneShotClipProgram(
            tn, un, source=u['source'], dtype=_DTYPES[t['dtype']],
            window=t['window'], stride=t['stride'], keep=self.keep,
            device=device)
        # The one-hot head's output of each clip's window batch, held
        # until it is collected: what the check compares TransNet by.
        self._logits = None
        self.program.tn_model.cls_layer1.register_forward_hook(
            self._keep_logits)
        self.cp = dict(cfg['crop_params'])
        self.ratios = list(traffic['ratios'])
        if len(self.ratios) != 1:
            raise ValueError('crop_transnetv2 serves one ratio per clip')
        self.fc = int(traffic['frames'])
        self.h, self.w = int(traffic['height']), int(traffic['width'])
        self.fps = float(traffic['fps'])
        self.dests = [ref.dest_size(self.w, self.h, r) for r in self.ratios]
        self.frames_per_clip = self.fc
        self.last_fc_sel = None
        self._geometry = {}
        self._fused, self._kernel = fused, fused.saliency_postprocess

        def kernel(logp):
            self._maps = self._kernel(logp)
            return self._maps
        fused.saliency_postprocess = kernel

    def _keep_logits(self, module, args, out):
        self._logits = out

    def dispatch(self, clip):
        return super().dispatch(clip), self._logits

    def collect(self, ticket):
        ticket, logits = ticket
        return super().collect(ticket), logits

    def counts(self) -> dict:
        """The traced run's live sizes: model FLOPs with their dtypes (V2's
        window plan, its histogram ``bmm`` in float32; UNISAL), the stacks'
        conv FLOPs, the postprocess kernel's bytes."""
        tn = RefTransNetV2(**tn_kwargs(self.cfg))
        un = RefUNISAL(cnn_widen_factor=self.cfg['unisal']['cnn_widen_factor'])
        sal_hw = ref.sal_dims(self.w, self.h, self.cp['max_input_d'])
        picks = self.last_fc_sel
        dtype = self.cfg['transnet']['dtype']
        hist = v2_flops.histogram_bmm(self.fc)
        return {
            'model_flops': [
                (v2_flops.window_plan(tn, self.fc) - hist, dtype),
                (hist, 'float32'),
                (flops.unisal_static(un, picks, ref.net_size(sal_hw),
                                     sal_hw),
                 self.cfg['unisal']['conv_precision'])],
            'transnet_stack_flops': [(v2_flops.stacks(tn, self.fc), dtype)],
            'postprocess_bytes': kbytes.postprocess_bytes(picks, *sal_hw),
        }

    def reference(self, clip, control: bool = False) -> dict:
        """The reference's outputs of a clip in float32, with the picks'
        maps again under TF32 convolutions (``maps_tf32``) and V2's logits
        again in bf16 (``logits_bf16``); with ``control``, the control's:
        V2's conv and dense inputs and weights in float8 around bf16
        arithmetic, UNISAL in bf16."""
        low = torch.bfloat16 if control else torch.float32
        tn, un = ref_models(self.cfg, self.tn_state, self.un_state,
                            clip.device, tn_dtype=low, un_dtype=low)
        if control:
            crop_oneshot.fp8_emulate_(tn)
        u = self.cfg['unisal']
        out = ref_v2.crop_clip(tn, un, clip, self.cp, fps=self.fps,
                               ratios=self.ratios,
                               un_input_dtype=_DTYPES[u['input_dtype']],
                               source=u['source'])
        sal, tn_frames = out.pop('sal_frames'), out.pop('tn_frames')
        if not control:
            with tf32(True):
                out['maps_tf32'] = ref.saliency_maps(
                    un, sal, out['picks'],
                    input_dtype=_DTYPES[u['input_dtype']],
                    source=u['source'])
            out['logits_bf16'] = predict_frames(tn.to(torch.bfloat16),
                                                tn_frames)[0]
        return out

    def normalize(self, out) -> dict:
        out, logits = out
        got = super().normalize(out)
        got['logits'] = logits[:, self.keep[0]:self.keep[1], 0].reshape(
            -1)[:self.fc].float()
        return got

    def compare(self, got: dict, expect: dict) -> dict:
        """``crop_oneshot``'s numbers and the logit gaps
        (:func:`logit_gaps`)."""
        return {**super().compare(got, expect),
                **logit_gaps(got['logits'], expect)}
