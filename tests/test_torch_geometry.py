"""Port vs JAX: on-device sampling and scenes, connected components and the
clustering filter, and the whole geometry chain on one uint8 volume."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)


def _random_probs(rng, n, p_hi=0.06):
    return (rng.random(n) < p_hi).astype(np.float32) * 0.9


def _prob_cases():
    rng = np.random.default_rng(5)
    cases = [_random_probs(rng, int(rng.integers(10, 260)))
             for _ in range(12)]
    cases.append(np.zeros(40, np.float32))          # single scene
    cases.append(np.full(40, 0.9, np.float32))      # all-transition fallback
    first_hi = np.zeros(60, np.float32)
    first_hi[0] = 0.9                               # prob[0] > t quirk
    cases.append(first_hi)
    return cases


def test_sampling_and_scenes_exact():
    """Padded capacity, live count n < capacity, every skip of the JAX
    test: sel_mask, sel_idx (with its fill), fc_sel, ti and the segment
    arrays (with their fills) are exactly equal."""
    from retargetvid_tpu.pipeline.oneshot import (
        sample_frames_device as j_sample,
    )
    from retargetvid_tpu.pipeline.oneshot import (
        scene_bounds_device as j_scenes,
    )
    from retargetvid_tpu_torch.pipeline.oneshot import (
        sample_frames_device,
        scene_bounds_device,
    )

    fc_cap = 260
    t_sel_cap = fc_cap // 6 + fc_cap // 8 + 10
    s_cap = fc_cap // 2 + 4
    js = jax.jit(j_sample, static_argnums=(1, 2, 3))
    jb = jax.jit(j_scenes, static_argnums=(2, 3))
    rng = np.random.default_rng(3)
    for i, probs in enumerate(_prob_cases()):
        fc = len(probs)
        skip = int(rng.choice([1, 4, 6, 9])) if i % 2 else 6
        cap = fc_cap
        t_cap = t_sel_cap if skip >= 6 else fc_cap + 8
        pad = np.zeros(cap, np.float32)
        pad[:fc] = probs
        ref = [np.asarray(v) for v in js(jnp.asarray(pad), skip, cap, t_cap,
                                         n=fc)]
        out = [v.numpy() for v in sample_frames_device(
            torch.from_numpy(pad), skip, cap, t_cap, n=fc)]
        for name, a, b in zip(('sel_mask', 'sel_idx', 'fc_sel', 'ti'),
                              ref, out):
            assert np.array_equal(np.asarray(a, np.int64),
                                  np.asarray(b, np.int64)), (i, name)
        ref_s = [np.asarray(v) for v in jb(jnp.asarray(pad),
                                           jnp.asarray(ref[0]), cap, s_cap,
                                           n=fc)]
        out_s = [v.numpy() for v in scene_bounds_device(
            torch.from_numpy(pad), torch.from_numpy(out[0]), cap, s_cap,
            n=fc)]
        for name, a, b in zip(('starts', 'ends', 'sel_starts', 'sel_ends',
                               'n_segments'), ref_s, out_s):
            assert np.array_equal(np.asarray(a, np.int64),
                                  np.asarray(b, np.int64)), (i, name)


def _blob_maps(rng, t, h, w):
    """uint8 maps: a few Gaussian blobs, speckle, a thin spiral that needs
    more sweeps than the cap, and one empty frame."""
    yy, xx = np.mgrid[0:h, 0:w]
    maps = np.zeros((t, h, w), np.float32)
    for f in range(t):
        for _ in range(int(rng.integers(1, 4))):
            cy, cx = rng.uniform(0, h), rng.uniform(0, w)
            amp, s = rng.uniform(120, 255), rng.uniform(20, 300)
            maps[f] += amp * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / s)
        maps[f] += (rng.random((h, w)) < 0.01) * rng.uniform(0, 255, (h, w))
    # One 1-px square spiral: a connected path with many axis turns, so
    # its labels have not converged after 12 sweeps.
    spiral = np.zeros((h, w), bool)
    top, left, bottom, right = 1, 1, h - 2, w - 2
    while top < bottom and left < right:
        spiral[top, left:right + 1] = True
        spiral[top:bottom + 1, right] = True
        spiral[bottom, left:right + 1] = True
        spiral[top + 2:bottom + 1, left] = True
        top, left, bottom, right = top + 2, left + 2, bottom - 2, right - 2
        spiral[top, left - 2:left] = True     # into the next ring
    maps[1] = np.where(spiral, 200.0, 0.0)
    maps[2] = 0.0
    return np.clip(maps, 0, 255).astype(np.uint8)


@pytest.mark.parametrize('select_sum', [2, 1])
def test_connected_components_and_filter_exact(select_sum):
    from retargetvid_tpu.ops.clustering import _filter_one
    from retargetvid_tpu.ops.clustering import (
        connected_components as j_ccl,
    )
    from retargetvid_tpu.ops.threshold import threshold_saliency
    from retargetvid_tpu_torch.ops.clustering import (
        connected_components,
        filter_frames,
    )

    h, w = 60, 90
    maps = _blob_maps(np.random.default_rng(select_sum), 6, h, w)
    sm = np.asarray(threshold_saliency(jnp.asarray(maps, jnp.float32), 120))

    mask = sm > 0
    ref_labels = np.asarray(jax.jit(jax.vmap(
        functools.partial(j_ccl, n_iters=12)))(jnp.asarray(mask)))
    labels = connected_components(torch.from_numpy(mask), n_iters=12)
    assert np.array_equal(labels.numpy(), ref_labels)

    filt = functools.partial(_filter_one, min_cluster_size=26,
                             select_sum=select_sum, bridge=1, cc_iters=12)
    rf, rv, rn = [np.asarray(v) for v in jax.jit(jax.vmap(filt))(
        jnp.asarray(sm))]
    of, ov, on = [v.numpy() for v in filter_frames(
        torch.from_numpy(sm.copy()), min_cluster_size=26,
        select_sum=select_sum, bridge=1, cc_iters=12)]
    assert np.array_equal(ov, rv)
    assert np.array_equal(on, rn)
    assert np.array_equal(of > 0, rf > 0)           # surviving masks
    assert np.array_equal(of, rf)


def _geometry_inputs():
    """A 150-frame clip with cuts after frames 59 and 64 (a 5-frame shot),
    sampled every 6 frames; a uint8 saliency volume on the selected
    frames, with an empty map."""
    from retargetvid_tpu.ops.scenes import (
        fix_scene_bounds,
        predictions_to_scenes,
        scenes_to_selected,
    )
    from retargetvid_tpu.pipeline.ingest import sample_frames

    fc = 150
    probs = np.zeros(fc, np.float32)
    probs[[59, 64]] = 0.9
    _, true_inds, m2o = sample_frames(fc, probs, 6, fc)
    seg = fix_scene_bounds(predictions_to_scenes(probs, 0.1), fc)
    seg_sel = scenes_to_selected(seg, m2o)
    rng = np.random.default_rng(7)
    h, w = 140, 250
    yy, xx = np.mgrid[0:h, 0:w]
    t_sel = len(true_inds)
    maps = np.zeros((t_sel, h, w), np.float32)
    for i, f in enumerate(true_inds):
        cx = w * (0.2 + 0.6 * f / fc) if f < 60 else w * (0.8 - 0.4 * f / fc)
        cy = h * (0.5 + 0.2 * np.sin(f / 10.0))
        maps[i] = 250 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 400.0)
        maps[i] += (rng.random((h, w)) < 0.02) * rng.uniform(0, 255, (h, w))
    maps[5] = 0.0
    return (np.clip(maps, 0, 255).astype(np.uint8), true_inds, seg,
            seg_sel, fc)


def test_geometry_pipeline_exact_boxes():
    from retargetvid_tpu.config import sc_init_crop_params
    from retargetvid_tpu.pipeline.geometry import run_geometry
    from retargetvid_tpu_torch.ops.boxes import calc_dest_size
    from retargetvid_tpu_torch.pipeline.geometry import (
        GeometryConfig,
        bucket_size,
        geometry_pipeline,
        seg_bucket_size,
    )

    smaps, true_inds, seg, seg_sel, fc = _geometry_inputs()
    t_sel, h_proc, w_proc = smaps.shape
    h, w = 360, 640
    cp = sc_init_crop_params()
    dest = calc_dest_size(w, h, '1:3')
    kw = dict(fps=30.0, h_orig=h, w_orig=w, w_final=dest['w_final'],
              h_final=dest['h_final'])
    ref = run_geometry(smaps, true_inds, seg, seg_sel, cp, fc=fc, **kw)

    # The padding of run_geometry, for the port.
    t_sel_pad, t_out = bucket_size(t_sel), bucket_size(fc)
    s, s_pad = len(seg), seg_bucket_size(len(seg))
    vol = np.zeros((t_sel_pad, h_proc, w_proc), np.uint8)
    vol[:t_sel] = smaps
    sel_mask = np.arange(t_sel_pad) < t_sel
    ti = np.zeros(t_sel_pad, np.int64)
    ti[:t_sel] = true_inds
    ti[t_sel:] = ti[t_sel - 1] + np.arange(1, t_sel_pad - t_sel + 1)

    def pad_seg(arr, col):
        out = np.zeros(s_pad, np.int64)
        out[:s] = np.asarray(arr)[:, col]
        return torch.from_numpy(out)

    zero = torch.zeros((), dtype=torch.int32)
    out = geometry_pipeline(
        torch.from_numpy(vol), torch.from_numpy(sel_mask), t_sel,
        torch.from_numpy(ti), pad_seg(seg, 0), pad_seg(seg, 1),
        pad_seg(seg_sel, 0), pad_seg(seg_sel, 1), s, fc, zero, zero, zero,
        zero, cfg=GeometryConfig.from_crop_params(cp), t_out=t_out, **kw)
    boxes = out['boxes'].numpy()[:fc]
    n_box = int((boxes != ref['boxes']).any(axis=1).sum())
    print(f'geometry: {n_box} of {fc} boxes differ (tolerance 0)')
    assert len(seg) == 3 and n_box == 0
    for k in ('dx', 'dy'):
        err = np.abs(out[k].numpy()[:t_sel] - ref[k]).max()
        print(f'geometry {k}: max |diff| {err:.3g} (atol 1e-3)')
        np.testing.assert_allclose(out[k].numpy()[:t_sel], ref[k],
                                   rtol=0, atol=1e-3)
    for k in ('dxi', 'dyi', 'dxs', 'dys'):
        err = np.abs(out[k].numpy()[:fc] - ref[k]).max()
        print(f'geometry {k}: max |diff| {err:.3g} (atol 1e-2)')
        np.testing.assert_allclose(out[k].numpy()[:fc], ref[k], rtol=0,
                                   atol=1e-2)


#: Crop-parameter settings the geometry serves: both presets and each
#: further knob (over the ICIP preset unless named).
SETTINGS = {
    'icip': {},
    'ism': {'use_best_settings': True},
    't_border': {'t_border': 10},
    'shift_time': {'shift_time': 5},
    'argmax_center': {'com_km': False},
    'adaptive_link': {'tpu_adaptive_link': True},
    'cubic_factor4': {'resize_factor': 4, 'resize_type': 2},
    'nearest_factor4': {'resize_factor': 4, 'resize_type': 3},
    'focus_stability': {'focus_stability': True},
    'savgol': {'loess_filt': 0},
    'ism_no_filter': {'use_best_settings': True, 'clust_filt': False},
}


@pytest.mark.parametrize('name', sorted(SETTINGS))
def test_every_setting_runs(name):
    """Each setting's GeometryConfig drives border detection and the whole
    chain on a tiny volume: boxes inside the frame (less the borders) at
    the bordered destination size, finite series."""
    from retargetvid_tpu_torch.config import sc_init_crop_params
    from retargetvid_tpu_torch.ops.border import border_detection
    from retargetvid_tpu_torch.pipeline.geometry import (
        GeometryConfig,
        geometry_pipeline,
    )

    knobs = dict(SETTINGS[name])
    cp = sc_init_crop_params(use_best_settings=knobs.pop(
        'use_best_settings', False))
    cp.update(knobs)
    cfg = GeometryConfig.from_crop_params(cp)
    fc, h, w, t_sel_pad, s_pad = 60, 48, 80, 32, 4
    rng = np.random.default_rng(12)
    maps = np.zeros((t_sel_pad, h, w), np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    for i in range(11):
        cx, cy = w * (0.2 + 0.06 * i), h * (0.5 + 0.3 * np.sin(i))
        blob = 250 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 60.0)
        maps[i] = np.clip(blob + (rng.random((h, w)) < 0.03) * 200, 0, 255)
    maps[:, :, :6] = 0                          # a dark left band
    vol = torch.from_numpy(maps)
    borders = border_detection(vol.to(torch.float32), cp['t_border'],
                               2 * h, 2 * w)
    out = geometry_pipeline(
        vol, torch.arange(t_sel_pad) < 11, 11,
        torch.arange(t_sel_pad) * 6, torch.tensor([0, 30, 0, 0]),
        torch.tensor([29, 59, 0, 0]), torch.tensor([0, 5, 0, 0]),
        torch.tensor([4, 10, 0, 0]), 2, fc, *borders.values(), cfg=cfg,
        fps=30.0, h_orig=2 * h, w_orig=2 * w, w_final=2 * w // 3,
        h_final=2 * h, t_out=64)
    boxes = out['boxes'].numpy()[:fc]
    bl, br = int(borders['border_l']), int(borders['border_r'])
    assert (bl > 0) == (name == 't_border')
    assert (boxes[:, 0] >= bl).all() and (boxes[:, 2] <= 2 * w - br).all()
    assert (boxes[:, 1] >= 0).all() and (boxes[:, 3] <= 2 * h).all()
    assert (boxes[:, 2] - boxes[:, 0] == int(out['fbb_w'])).all()
    assert (boxes[:, 3] - boxes[:, 1] == int(out['fbb_h'])).all()
    assert np.isfinite(out['dxs'].numpy()[:fc]).all()
