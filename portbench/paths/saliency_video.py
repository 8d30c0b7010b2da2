"""Entry path: ``SaliencyPredictor.predict_video`` of
``retargetvid_tpu_torch`` (UNISAL's dynamic mode: the frame-modulo chunk
loop through the ConvGRU, optional smoothing, one postprocess launch over
the clip's (T, H, W) stack), as ``cli predict --dynamic`` runs it.  The
call returns the uint8 maps on the host, so a clip is dispatched and
collected in one.

The check: for each sampled pool clip, every map stack the window produced
against the plain reference (``portbench/reference/pipeline.py:
saliency_video``) in float32 with TF32 off, on the same clip and weights.
"""

from __future__ import annotations

import torch

from portbench import inputs
from portbench.check import map_gaps, run_check, tf32
from portbench.counts import bytes as kbytes
from portbench.counts import flops
from portbench.reference import pipeline as ref
from portbench.reference.unisal import UNISAL as RefUNISAL

_DTYPES = {'bfloat16': torch.bfloat16, 'float32': torch.float32}


def compare(got: dict, expect: dict) -> dict:
    """The gaps of the clip's uint8 maps (``check.map_gaps``)."""
    return map_gaps(got['maps'], expect)


class Adapter:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        from retargetvid_tpu_torch.models.unisal import UNISAL
        from retargetvid_tpu_torch.pipeline.saliency import SaliencyPredictor
        self.cfg, self.seed = cfg, seed
        self.device = device
        u = cfg['unisal']
        with torch.device(device):
            un = UNISAL(cnn_widen_factor=u['cnn_widen_factor'])
        un = un.to(device)
        inputs.seed_weights_(un, seed, 2, device)
        self.un_state = inputs.state_of(un)
        self.dtype = _DTYPES[u['input_dtype']]
        self.predictor = SaliencyPredictor(un.to(_DTYPES[u['param_dtype']]),
                                           source=u['source'],
                                           dtype=self.dtype, device=device)
        self.fc = int(traffic['frames'])
        self.h, self.w = int(traffic['height']), int(traffic['width'])
        self.kw = dict(source=u['source'],
                       frame_modulo=int(traffic['frame_modulo']),
                       seq_len=int(traffic['seq_len']))
        self.smooth = traffic.get('smooth')
        if self.smooth is not None:
            raise ValueError('the reference has no smoothing')
        self.frames_per_clip = self.fc

    def make_pool(self, n: int) -> list:
        return inputs.clip_pool(n, self.fc, self.h, self.w, self.seed,
                                self.device)

    def make_timer(self):
        from retargetvid_tpu_torch.pipeline.oneshot import StageTimer
        return StageTimer()

    def set_timer(self, timer) -> None:
        self.predictor.timer = timer

    def dispatch(self, clip):
        return self.predictor.predict_video(clip, smooth_method=self.smooth,
                                            **self.kw)

    def collect(self, maps):
        return maps

    def counts(self) -> dict:
        un = RefUNISAL(cnn_widen_factor=self.cfg['unisal']['cnn_widen_factor'])
        un.load_state_dict(self.un_state)
        hw = (self.h, self.w)
        return {
            'model_flops': [(flops.unisal_dynamic(
                un, self.fc, ref.net_size(hw), hw, self.kw['seq_len'],
                self.kw['frame_modulo']),
                self.cfg['unisal']['conv_precision'])],
            'postprocess_bytes': kbytes.postprocess_bytes(self.fc, *hw),
        }

    def release(self) -> None:
        self.predictor = None

    def reference(self, clip, control: bool = False) -> dict:
        """The reference's maps of a clip in float32, and again under TF32
        convolutions (``maps_tf32``); with ``control``, UNISAL in bf16."""
        dtype = torch.bfloat16 if control else torch.float32
        un = RefUNISAL(cnn_widen_factor=self.cfg['unisal']['cnn_widen_factor'])
        un.load_state_dict(self.un_state)
        un = un.to(clip.device, dtype).eval()
        out = {'maps': torch.from_numpy(
            ref.saliency_video(un, clip, dtype=dtype, **self.kw))}
        if not control:
            with tf32(True):
                out['maps_tf32'] = torch.from_numpy(
                    ref.saliency_video(un, clip, dtype=dtype, **self.kw))
        return out

    def normalize(self, maps) -> dict:
        return {'maps': torch.from_numpy(maps)}

    compare = staticmethod(compare)

    def check(self, outputs: dict, clips: list, control: bool = False):
        return run_check(self, outputs, clips, control)
