"""The plain reference of the one-shot crop path with TransNet V2 as the
shot detector: :func:`pipeline.crop_clip`'s order of work with the
published V2 window plan (:func:`transnetv2.predict_frames`) in place of
V1's full sequence, and cuts above V2's published threshold, 0.5.

The host sampling rule and scene list are :mod:`pipeline`'s, given the
cut decisions as probabilities 1 and 0: they compare with V1's 0.1 alone,
so each frame is a cut there exactly when its V2 probability is above
0.5.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import pipeline as ref
from portbench.reference.resize import resize
from portbench.reference.transnetv2 import predict_frames

#: The published cut threshold of ``sigmoid(one_hot)``.
THRESHOLD = 0.5


@torch.no_grad()
def shots(tn, raw, crop_params: dict) -> dict:
    """:func:`pipeline.shots` with V2: also ``logits`` (fc,), the one-hot
    head's, float32 on the clip's device, and the 27x48 ``tn_frames``."""
    fc, h, w = (int(s) for s in raw.shape[:3])
    sal_hw = ref.sal_dims(w, h, crop_params['max_input_d'])
    tn_frames = ref.to_u8(resize(raw, (27, 48), 'linear', channels_last=True))
    sal_frames = ref.to_u8(resize(raw, sal_hw, 'linear', channels_last=True))
    logits, probs = predict_frames(tn, tn_frames)
    probs = probs.cpu().numpy()
    cuts = (probs > THRESHOLD).astype(np.float32)
    picks, map2orig = ref.sample_frames(cuts, int(crop_params['skip']), fc)
    seg = ref.scenes(cuts, fc)
    return {'probs': probs, 'logits': logits, 'picks': picks, 'seg': seg,
            'seg_sel': np.asarray(map2orig)[seg], 'sal_frames': sal_frames,
            'tn_frames': tn_frames}


@torch.no_grad()
def crop_clip(tn, un, raw, crop_params: dict, *, fps: float, ratios,
              un_input_dtype=torch.bfloat16, source: str = 'SALICON') -> dict:
    """(fc, H, W, 3) uint8 clip -> every stage's outputs, as
    :func:`pipeline.crop_clip` gives them, and ``logits``."""
    fc, h, w = (int(s) for s in raw.shape[:3])
    shot = shots(tn, raw, crop_params)
    maps = ref.saliency_maps(un, shot['sal_frames'], shot['picks'],
                             input_dtype=un_input_dtype, source=source)
    seg = shot['seg']
    return {**shot, 'maps': maps, 'fc_sel': len(shot['picks']),
            'n_segments': len(seg), 'sel_idx': np.asarray(shot['picks']),
            'seg_starts': seg[:, 0], 'seg_ends': seg[:, 1],
            **ref.geometry(maps, shot, crop_params, fps=fps, ratios=ratios,
                           h=h, w=w)}
