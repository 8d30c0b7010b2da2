"""The port's one-shot program with the window plan (its default, as in
the JAX package) vs the JAX one, and vs the port's own two-dispatch path:
the same picks, shots and boxes.

The clip, models and weights are those of ``test_torch_oneshot.py``
(fc=48 at 72x128, ``TINY_UNISAL_CFG``, float32) with a narrow TransNet
(``f=2, d=16``, head biased) run as three 100-frame windows.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_fused import _crop_params, _host_tables
from test_torch_oneshot import FC, H, W, clip_frames, models, saliency_maps

torch.set_num_threads(1)


@pytest.fixture(scope='module')
def runs():
    from retargetvid_tpu.config import sc_init_crop_params
    from retargetvid_tpu.ops.boxes import calc_dest_size
    from retargetvid_tpu.pipeline.oneshot import OneShotClipProgram as JProg
    from retargetvid_tpu_torch.pipeline.oneshot import OneShotClipProgram

    cp = sc_init_crop_params()
    cp['out_ratio'] = '1:3'
    dest = calc_dest_size(W, H, cp['out_ratio'])
    kw = dict(fps=30.0, w_final=dest['w_final'], h_final=dest['h_final'])
    frames = clip_frames()
    jt, tn_params, ju, un_vars, tn, un = models(f=2, d=16)
    ref = JProg(jt, tn_params, variables=un_vars, model=ju,
                dtype=jnp.float32).run(jnp.asarray(frames), cp, **kw)
    program = OneShotClipProgram(tn, un, dtype=torch.float32, device='cpu')
    assert not program.tn_fullseq
    out = program.run(frames, cp, **kw)
    return ref, out, (ju, un_vars, un, frames)


def test_windowed_structure_exact(runs):
    ref, out, _ = runs
    assert out['fc_sel'] == ref['fc_sel'] > 0
    assert out['n_segments'] == ref['n_segments']
    for k in ('sel_idx', 'seg_starts', 'seg_ends'):
        assert np.array_equal(np.asarray(out[k], np.int64),
                              np.asarray(ref[k], np.int64)), k


def test_windowed_probs(runs):
    ref, out, _ = runs
    err = np.abs(out['probs'] - ref['probs']).max()
    print(f'probs: max |diff| {err:.3g} (atol 1e-5)')
    assert out['probs'].shape == ref['probs'].shape == (FC,)
    np.testing.assert_allclose(out['probs'], ref['probs'], rtol=0,
                               atol=1e-5)


def test_windowed_boxes_exact(runs):
    ref, out, (ju, un_vars, un, frames) = runs
    jmaps, tmaps = saliency_maps(ju, un_vars, un, frames,
                                 ref['sel_idx'][:ref['fc_sel']])
    n_px = int((jmaps != tmaps).sum())
    n_box = int((out['boxes'] != ref['boxes']).any(1).sum())
    print(f'saliency maps: {n_px} of {jmaps.size} uint8 pixels differ; '
          f'boxes: {n_box} of {FC} frames differ (tolerance 0)')
    assert out['boxes'].shape == ref['boxes'].shape == (FC, 4)
    assert n_box == 0


def test_windowed_oneshot_matches_two_dispatch():
    """The port's one-shot program with the window plan == its two-dispatch
    path (TransNetPredictor, host sampling and scenes, FusedClipProgram):
    the same picks and shots, and identical boxes."""
    from retargetvid_tpu_torch.models.transnet import TransNetPredictor
    from retargetvid_tpu_torch.pipeline.fused import FusedClipProgram
    from retargetvid_tpu_torch.pipeline.ingest import (
        _resize_kernel,
        sal_dims,
    )
    from retargetvid_tpu_torch.pipeline.oneshot import OneShotClipProgram

    cp, kw = _crop_params()
    frames = clip_frames()
    *_, tn, un = models(f=2, d=16)
    one = OneShotClipProgram(tn, un, dtype=torch.float32, device='cpu').run(
        frames, cp, fps=kw['fps'], w_final=kw['w_final'],
        h_final=kw['h_final'])

    tn_frames, sal = _resize_kernel(H, W, *sal_dims(W, H, 250))(
        torch.from_numpy(frames))
    probs = TransNetPredictor(tn, device='cpu')(tn_frames)
    tables = _host_tables(probs, cp['skip'], port=True)
    two = FusedClipProgram(un, dtype=torch.float32, device='cpu').run(
        sal, *tables, cp, **kw)

    assert one['fc_sel'] == len(tables[0])
    assert one['n_segments'] == len(tables[2])
    np.testing.assert_allclose(one['probs'], probs, rtol=0, atol=1e-5)
    assert np.array_equal(one['boxes'], two['boxes'].astype(np.int32))
