"""The whole slice under the ISM-2021 preset: the port's one-shot and
two-dispatch programs against the JAX ones.

The clip is the 72x128 clip of ``test_torch_oneshot.py`` at 64 frames,
not 48: the JAX package's Savitzky-Golay correlates each segment with
every window of its 30 fps bank (5..59), and ``jnp.correlate(mode='same')``
returns the longer of its two inputs, so a clip whose frame bucket is
shorter than 59 (fc <= 48) fails to trace in JAX.  The port serves it
(``test_ism_short_clip``).

Tolerances: picks and shots exact; boxes <= 1 px (the saliency maps differ
from JAX's by the pinned ingest-resize rounding,
``tests/test_torch_resize.py``); centers, jump scores and smoothed series
atol 1e-2.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_fused import _host_tables
from test_torch_oneshot import FC, H, W, clip_frames, models

torch.set_num_threads(1)


#: The whole slice's clip length (see the module docstring).
FC_ISM = 64


def _ism_params():
    from retargetvid_tpu_torch.config import sc_init_crop_params
    from retargetvid_tpu_torch.ops.boxes import calc_dest_size
    cp = sc_init_crop_params(use_best_settings=True)
    cp['out_ratio'] = '1:3'
    dest = calc_dest_size(W, H, cp['out_ratio'])
    return cp, dict(fps=30.0, w_final=dest['w_final'],
                    h_final=dest['h_final'])


@pytest.fixture(scope='module')
def ism_slice():
    """The 64-frame clip through the JAX and the port one-shot programs
    under ISM (full-sequence plan, float32)."""
    from retargetvid_tpu.pipeline.oneshot import OneShotClipProgram as JProg
    from retargetvid_tpu_torch.pipeline.oneshot import OneShotClipProgram

    cp, kw = _ism_params()
    frames = clip_frames(FC_ISM)
    jt, tn_params, ju, un_vars, tn, un = models()
    ref = JProg(jt, tn_params, variables=un_vars, model=ju,
                dtype=jnp.float32, tn_fullseq=True).run(
        jnp.asarray(frames), cp, **kw)
    out = OneShotClipProgram(tn, un, dtype=torch.float32, tn_fullseq=True,
                             device='cpu').run(frames, cp, **kw)
    return ref, out


def test_ism_oneshot_slice(ism_slice):
    ref, out = ism_slice
    assert out['fc_sel'] == ref['fc_sel'] > 0
    assert out['n_segments'] == ref['n_segments']
    box_err = int(np.abs(out['boxes'] - ref['boxes']).max())
    print(f'ISM one-shot: boxes max |diff| {box_err} px (tolerance 1 px), '
          f'{int((out["boxes"] != ref["boxes"]).any(1).sum())} of {FC_ISM} '
          f'frames differ')
    assert out['boxes'].shape == ref['boxes'].shape == (FC_ISM, 4)
    assert box_err <= 1
    n = ref['fc_sel']
    for k, m in (('dx', n), ('dy', n), ('jumps', n), ('dxs', FC_ISM),
                 ('dys', FC_ISM)):
        err = np.abs(out[k][:m] - ref[k][:m]).max()
        print(f'ISM one-shot {k}: max |diff| {err:.3g} (atol 1e-2)')
        np.testing.assert_allclose(out[k][:m], ref[k][:m], rtol=0,
                                   atol=1e-2)


def test_ism_fused_slice():
    """The two-dispatch program under ISM on the 64-frame clip with a cut
    every 4 frames from frame 4 to 40 (11 shots, segment bucket 16): the
    cut-boundary redo runs the factor-4 roundtrip for every cut."""
    from retargetvid_tpu.pipeline.fused import FusedClipProgram as JFused
    from retargetvid_tpu.pipeline.ingest import _resize_kernel as j_resize
    from retargetvid_tpu_torch.pipeline.fused import FusedClipProgram
    from retargetvid_tpu_torch.pipeline.ingest import (
        _resize_kernel,
        sal_dims,
    )

    cp, kw = _ism_params()
    kw.update(h_orig=H, w_orig=W, fc=FC_ISM)
    profile = np.zeros(FC_ISM, np.float32)
    profile[4:44:4] = 0.9
    frames = clip_frames(FC_ISM)
    sal_hw = sal_dims(W, H, cp['max_input_d'])
    _, _, ju, un_vars, _, un = models(f=2, d=16)
    tables = _host_tables(profile, cp['skip'], port=True)
    _, j_sal = j_resize(H, W, *sal_hw)(jnp.asarray(frames))
    ref = JFused(variables=un_vars, model=ju, dtype=jnp.float32).run(
        j_sal, *_host_tables(profile, cp['skip'], port=False), cp,
        seg_bucket=16, **kw)
    _, sal = _resize_kernel(H, W, *sal_hw)(torch.from_numpy(frames))
    out = FusedClipProgram(un, dtype=torch.float32, device='cpu').run(
        sal, *tables, cp, seg_bucket=16, **kw)
    assert len(tables[2]) == 11
    box_err = int(np.abs(out['boxes'] - ref['boxes']).max())
    print(f'ISM two-dispatch: boxes max |diff| {box_err} px (tolerance '
          f'1 px)')
    assert out['boxes'].shape == ref['boxes'].shape == (FC_ISM, 4)
    assert box_err <= 1
    for k in ('dx', 'dy', 'jumps', 'dxs', 'dys'):
        err = np.abs(out[k] - ref[k]).max()
        print(f'ISM two-dispatch {k}: max |diff| {err:.3g} (atol 1e-2)')
        np.testing.assert_allclose(out[k], ref[k], rtol=0, atol=1e-2)


def test_ism_short_clip():
    """The 48-frame clip (frame bucket 48 < the widest window 59), which
    the JAX package cannot trace under ISM: the port serves it, with boxes
    inside the frame at the destination size and finite series."""
    from retargetvid_tpu_torch.pipeline.oneshot import OneShotClipProgram

    cp, kw = _ism_params()
    *_, tn, un = models()
    out = OneShotClipProgram(tn, un, dtype=torch.float32, tn_fullseq=True,
                             device='cpu').run(clip_frames(), cp, **kw)
    boxes = out['boxes']
    assert boxes.shape == (FC, 4)
    assert (boxes[:, 2] - boxes[:, 0] == kw['w_final']).all()
    assert (boxes[:, 3] - boxes[:, 1] == kw['h_final']).all()
    assert (boxes[:, :2] >= 0).all() and (boxes[:, 2] <= W).all()
    assert np.isfinite(out['dxs'][:FC]).all()
