"""The two-dispatch path: the port's FusedClipProgram vs the JAX one, and
the geometry chain split into its ratio-independent part and its box tail.

The clip, models and weights are those of ``test_torch_oneshot.py``
(fc=48 at 72x128, ``TINY_UNISAL_CFG``, float32).  The FusedClipProgram
cases drive a 10-cut probability profile (11 shots, segment bucket 16),
more shots than the one-shot program's ``s_pad`` of 8.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_oneshot import FC, H, W, clip_frames, models, saliency_maps

torch.set_num_threads(1)

#: Transition probability profile: a cut every 4 frames from frame 4.
PROFILE = np.zeros(FC, np.float32)
PROFILE[4:44:4] = 0.9


def _crop_params():
    from retargetvid_tpu_torch.config import sc_init_crop_params
    from retargetvid_tpu_torch.ops.boxes import calc_dest_size
    cp = sc_init_crop_params()
    cp['out_ratio'] = '1:3'
    dest = calc_dest_size(W, H, cp['out_ratio'])
    return cp, dict(fps=30.0, h_orig=H, w_orig=W, w_final=dest['w_final'],
                    h_final=dest['h_final'], fc=FC)


def _host_tables(probs, skip, port: bool):
    """Sampling and scene tables of the two-dispatch path, from the port's
    host functions or the JAX package's."""
    if port:
        from retargetvid_tpu_torch.ops import scenes
        from retargetvid_tpu_torch.pipeline.ingest import (
            TRANS_THRESHOLD,
            sample_frames,
        )
    else:
        from retargetvid_tpu.ops import scenes
        from retargetvid_tpu.pipeline.ingest import (
            TRANS_THRESHOLD,
            sample_frames,
        )
    fc = len(probs)
    selected, true_inds, m2o = sample_frames(fc, probs, skip, fc)
    seg = scenes.fix_scene_bounds(
        scenes.predictions_to_scenes(probs, TRANS_THRESHOLD), fc)
    return selected, true_inds, seg, scenes.scenes_to_selected(seg, m2o)


@pytest.fixture(scope='module')
def fused():
    from retargetvid_tpu.pipeline.fused import FusedClipProgram as JFused
    from retargetvid_tpu.pipeline.ingest import _resize_kernel as j_resize
    from retargetvid_tpu_torch.pipeline.fused import FusedClipProgram
    from retargetvid_tpu_torch.pipeline.ingest import (
        _resize_kernel,
        sal_dims,
    )

    cp, kw = _crop_params()
    frames = clip_frames()
    sal_hw = sal_dims(W, H, cp['max_input_d'])
    _, _, ju, un_vars, _, un = models(f=2, d=16)
    j_tables = _host_tables(PROFILE, cp['skip'], port=False)
    tables = _host_tables(PROFILE, cp['skip'], port=True)
    _, j_sal = j_resize(H, W, *sal_hw)(jnp.asarray(frames))
    ref = JFused(variables=un_vars, model=ju, dtype=jnp.float32).run(
        j_sal, *j_tables, cp, seg_bucket=16, **kw)
    _, sal = _resize_kernel(H, W, *sal_hw)(torch.from_numpy(frames))
    out = FusedClipProgram(un, dtype=torch.float32, device='cpu').run(
        sal, *tables, cp, seg_bucket=16, **kw)
    return ref, out, j_tables, tables, (ju, un_vars, un, frames)


def test_fused_structure_exact(fused):
    """Picks and both scene tables equal JAX's; 11 shots."""
    ref, out, j_tables, tables, _ = fused
    for name, a, b in zip(('selected', 'true_inds', 'seg', 'seg_sel'),
                          j_tables, tables):
        assert np.array_equal(np.asarray(a), np.asarray(b)), name
    assert len(tables[2]) == 11
    t_sel = len(tables[0])
    assert out['dx'].shape == ref['dx'].shape == (t_sel,)


def test_fused_boxes(fused):
    """Within 1 px; exactly equal when the uint8 saliency maps are."""
    ref, out, _, tables, (ju, un_vars, un, frames) = fused
    jmaps, tmaps = saliency_maps(ju, un_vars, un, frames, tables[0])
    map_diff = np.abs(jmaps.astype(int) - tmaps.astype(int))
    box_err = int(np.abs(out['boxes'] - ref['boxes']).max())
    print(f'saliency maps: {int((map_diff > 0).sum())} of {map_diff.size} '
          f'uint8 pixels differ; boxes: max |diff| {box_err} px '
          f'(tolerance 1 px; 0 where the maps are equal)')
    assert out['boxes'].shape == ref['boxes'].shape == (FC, 4)
    assert box_err <= 1
    if map_diff.max() == 0:
        assert box_err == 0


def test_fused_series(fused):
    ref, out, _, _, _ = fused
    for k in ('dx', 'dy', 'dxs', 'dys', 'dxi', 'dyi'):
        err = np.abs(out[k] - ref[k]).max()
        print(f'{k}: max |diff| {err:.3g} (atol 1e-2)')
        np.testing.assert_allclose(out[k], ref[k], rtol=0, atol=1e-2)


def test_geometry_split_bit_identical():
    """``geometry_pipeline`` == ``geometry_series`` then ``geometry_boxes``,
    bit for bit, for two output sizes."""
    from retargetvid_tpu_torch.config import sc_init_crop_params
    from retargetvid_tpu_torch.ops.scenes import (
        fix_scene_bounds,
        predictions_to_scenes,
        scenes_to_selected,
    )
    from retargetvid_tpu_torch.pipeline.geometry import (
        GeometryConfig,
        geometry_boxes,
        geometry_pipeline,
        geometry_series,
    )
    from retargetvid_tpu_torch.pipeline.ingest import sample_frames

    fc, h, w, t_sel_pad, s_pad = 60, 48, 80, 32, 4
    probs = np.zeros(fc, np.float32)
    probs[[20, 23]] = 0.9
    _, true_inds, m2o = sample_frames(fc, probs, 6, fc)
    seg = fix_scene_bounds(predictions_to_scenes(probs, 0.1), fc)
    seg_sel = scenes_to_selected(seg, m2o)
    rng = np.random.default_rng(2)
    yy, xx = np.mgrid[0:h, 0:w]
    t_sel = len(true_inds)
    maps = np.zeros((t_sel_pad, h, w), np.float32)
    for i, f in enumerate(true_inds):
        cx, cy = w * (0.2 + 0.6 * f / fc), h * (0.5 + 0.2 * np.sin(f / 9))
        maps[i] = 250 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 150.0)
        maps[i] += (rng.random((h, w)) < 0.02) * rng.uniform(0, 255, (h, w))
    smaps = torch.from_numpy(np.clip(maps, 0, 255).astype(np.uint8))
    ti = np.arange(t_sel_pad) + true_inds[-1] - t_sel + 1
    ti[:t_sel] = true_inds

    def pad_seg(arr, col):
        out = np.zeros(s_pad, np.int64)
        out[:len(seg)] = np.asarray(arr)[:, col]
        return torch.from_numpy(out)

    args = (smaps, torch.arange(t_sel_pad) < t_sel, t_sel,
            torch.from_numpy(ti), pad_seg(seg, 0), pad_seg(seg, 1),
            pad_seg(seg_sel, 0), pad_seg(seg_sel, 1), len(seg))
    cfg = GeometryConfig.from_crop_params(sc_init_crop_params())
    borders = [torch.zeros((), dtype=torch.int32)] * 4
    orig = dict(h_orig=2 * h, w_orig=2 * w)
    series = geometry_series(*args, cfg=cfg, fps=30.0, t_out=64)
    for wf, hf in ((2 * w // 3, 2 * h), (2 * w, 2 * h // 3)):
        whole = geometry_pipeline(*args, fc, *borders, cfg=cfg, fps=30.0,
                                  w_final=wf, h_final=hf, t_out=64, **orig)
        parts = {**series, **geometry_boxes(
            series, *borders, h_process=h, w_process=w, w_final=wf,
            h_final=hf, **orig)}
        assert whole.keys() == parts.keys()
        for k in whole:
            assert torch.equal(whole[k], parts[k]), k
        assert int(whole['boxes'][0, 2] - whole['boxes'][0, 0]) == wf
