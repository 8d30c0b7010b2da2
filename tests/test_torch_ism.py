"""Port vs JAX under the ISM-2021 preset and every further crop-parameter
knob, module by module: center of mass, focus-jump scores and freezing,
adaptive linking, Savitzky-Golay, the order-2 Butterworth, the time shift,
border detection and coverage, the factor-4 filter roundtrip, and the
geometry chain.  The whole slice is ``test_torch_ism_slice.py``.

Tolerances: integer outputs exact; centers and jump scores atol 1e-3;
smoothed series atol 1e-2; boxes 0 px on the geometry chain.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_geometry import _geometry_inputs
from test_torch_resize import _tap_sums

torch.set_num_threads(1)


def _blobs(rng, t, h, w, n_blobs=2, speckle=0.02):
    """uint8 maps of Gaussian blobs over sparse speckle."""
    yy, xx = np.mgrid[0:h, 0:w]
    maps = np.zeros((t, h, w), np.float32)
    for f in range(t):
        for _ in range(n_blobs):
            cy, cx = rng.uniform(0, h), rng.uniform(0, w)
            amp, s = rng.uniform(120, 255), rng.uniform(20, 300)
            maps[f] += amp * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / s)
        maps[f] += (rng.random((h, w)) < speckle) * rng.uniform(0, 255,
                                                                 (h, w))
    return np.clip(maps, 0, 255).astype(np.uint8)


@pytest.mark.parametrize('km,factor', [(False, 1.0), (False, 4.0),
                                       (True, 4.0)])
def test_center_of_mass(km, factor):
    from retargetvid_tpu.ops.center import center_of_mass as j_com
    from retargetvid_tpu_torch.ops.center import center_of_mass

    maps = _blobs(np.random.default_rng(11), 6, 140, 250).astype(np.float32)
    maps[2] = 0.0                                   # an empty map
    maps[3, 10, 20] = maps[3, 50, 7] = 300.0        # two equal maxima
    ref = [np.asarray(v) for v in jax.jit(functools.partial(
        j_com, km=km, factor=factor))(jnp.asarray(maps))]
    out = [v.numpy() for v in center_of_mass(torch.from_numpy(maps), km=km,
                                             factor=factor)]
    assert np.array_equal(out[2], ref[2]) and not out[2][2]
    if not km:                      # argmax: integer positions, exact
        assert (out[0][3], out[1][3]) == (20.0, 10.0)
        assert np.array_equal(out[0], ref[0])
        assert np.array_equal(out[1], ref[1])
    for a, b in zip(out[:2], ref[:2]):
        err = np.abs(a - b).max()
        print(f'center km={km} factor={factor}: max |diff| {err:.3g} '
              f'(atol 1e-3)')
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-3)


def test_jump_saliency_scores():
    """Lines that leave the frame on every side, steep and flat, axis-
    aligned, sub-``min_d_jump`` and zero moves: equal to JAX's scores."""
    from retargetvid_tpu.ops.focus import jump_saliency_scores as j_jump
    from retargetvid_tpu_torch.ops.focus import jump_saliency_scores

    h, w = 36, 64
    rng = np.random.default_rng(4)
    pts = [(5.5, 5.2), (70.3, 3.1), (60.0, -8.4), (-6.7, 30.0), (20.2, 44.9),
           (20.2, 10.0), (50.9, 10.0), (51.4, 10.6), (51.4, 10.6),
           (10.0, 35.5), (63.0, 0.0), (0.0, 35.0), (33.3, 17.7)]
    cx = np.asarray([p[0] for p in pts], np.float32)
    cy = np.asarray([p[1] for p in pts], np.float32)
    maps = rng.integers(0, 256, (len(pts), h, w)).astype(np.float32)
    for min_d in (1.0, 10.0):
        ref = np.asarray(jax.jit(functools.partial(j_jump, min_d_jump=min_d))(
            jnp.asarray(maps), jnp.asarray(cx), jnp.asarray(cy)))
        out = jump_saliency_scores(torch.from_numpy(maps),
                                   torch.from_numpy(cx), torch.from_numpy(cy),
                                   min_d_jump=min_d).numpy()
        err = np.abs(out - ref).max()
        print(f'jump scores, min_d_jump={min_d}: max |diff| {err:.3g} '
              f'(tolerance 0: integer sums, one division)')
        assert np.array_equal(out, ref)
        assert out[0] == 255.0 and out[8] == 255.0     # first, zero move
    assert ref[7] == 255.0                             # 0.5 px < min_d 10


#: (jump indices, fc_sel, skip, fps, stab_secs) of the freeze cases.
FREEZE_CASES = {
    'none': ([], 40, 6, 30.0, 1.5),
    'one': ([7], 40, 6, 30.0, 1.5),
    'chained': ([3, 6, 8, 15, 17, 18, 30, 38], 40, 6, 30.0, 1.5),
    # A 6-frame span at 6 / 24 s per pick is exactly 1.5 s: frozen.
    'at_limit': ([10, 14], 40, 6, 24.0, 1.5),
    # A 10-frame span at 6 / 30 s per pick is 2.0 s in float64 but
    # 2.0000002 in JAX's float32: not frozen.
    'float32_limit': ([30, 38], 40, 6, 30.0, 2.0),
    # The span's end is clipped to fc_sel - 1.
    'last_frame': ([33, 39], 40, 6, 30.0, 1.5),
}


@pytest.mark.parametrize('case', sorted(FREEZE_CASES))
def test_freeze_unstable_segments(case):
    from retargetvid_tpu.ops.temporal import (
        freeze_unstable_segments as j_freeze,
    )
    from retargetvid_tpu_torch.ops.temporal import (
        freeze_unstable_segments,
        frozen_spans,
    )

    jumps, fc_sel, skip, fps, stab = FREEZE_CASES[case]
    rng = np.random.default_rng(len(jumps))
    dx = rng.uniform(0, 250, 48).astype(np.float32)
    dy = rng.uniform(0, 140, 48).astype(np.float32)
    padded = np.full(48, 10 ** 6, np.int32)
    padded[:len(jumps)] = jumps
    ref = [np.asarray(v) for v in jax.jit(functools.partial(
        j_freeze, fc_sel=fc_sel, skip=skip, fps=fps, stab_secs=stab))(
        jnp.asarray(dx), jnp.asarray(dy), jnp.asarray(padded),
        jnp.int32(len(jumps)))]
    out = [v.numpy() for v in freeze_unstable_segments(
        torch.from_numpy(dx), torch.from_numpy(dy), jumps, fc_sel=fc_sel,
        skip=skip, fps=fps, stab_secs=stab)]
    assert np.array_equal(out[0], ref[0]) and np.array_equal(out[1], ref[1])
    spans = frozen_spans(jumps, fc_sel=fc_sel, skip=skip, fps=fps,
                         stab_secs=stab)
    expect = {'none': [], 'one': [], 'at_limit': [(9, 15)],
              'chained': [(2, 7), (5, 9), (14, 18), (16, 19)],
              'float32_limit': [], 'last_frame': [(32, 39)]}[case]
    print(f'freeze {case}: {len(spans)} spans frozen {spans}')
    assert spans == expect
    assert np.array_equal(out[0] != dx, ref[0] != dx)


def _speckle_masks():
    rng = np.random.default_rng(21)
    maps = _blobs(rng, 4, 48, 80, speckle=0.06)
    return np.asarray(maps) > 100


def test_adaptive_link_mask_and_filter():
    from retargetvid_tpu.ops.clustering import (
        _adaptive_link_mask as j_link,
    )
    from retargetvid_tpu.ops.clustering import _filter_one
    from retargetvid_tpu_torch.ops.clustering import (
        _adaptive_link_mask,
        filter_frames,
    )

    mask = _speckle_masks()
    ref = np.asarray(jax.jit(jax.vmap(functools.partial(
        j_link, min_samples=3, max_radius=4)))(jnp.asarray(mask)))
    out = _adaptive_link_mask(torch.from_numpy(mask), 3, 4).numpy()
    print(f'adaptive link: {int((out != ref).sum())} of {ref.size} pixels '
          f'differ (tolerance 0); {int(ref.sum() - mask.sum())} added')
    assert np.array_equal(out, ref) and ref.sum() > mask.sum()

    maps = np.where(mask, _blobs(np.random.default_rng(3), 4, 48, 80) + 1,
                    0).astype(np.float32)
    filt = functools.partial(_filter_one, min_cluster_size=5, select_sum=1,
                             bridge=1, cc_iters=12, adaptive_min_samples=3)
    rf, rv, rn = [np.asarray(v) for v in jax.jit(jax.vmap(filt))(
        jnp.asarray(maps))]
    of, ov, on = [v.numpy() for v in filter_frames(
        torch.from_numpy(maps), min_cluster_size=5, select_sum=1, bridge=1,
        cc_iters=12, adaptive_min_samples=3)]
    assert np.array_equal(ov, rv) and np.array_equal(on, rn)
    assert np.array_equal(of, rf)


def test_factor4_filter_upscale_rounding():
    """The filter's factor-4 roundtrip, pinned to its cause.  The 140x250
    -> 35x62 linear downscale (taps 0.5/0.5 on integers) and the upscale's
    height product (35 -> 140, dyadic weights) are exact in any order; the
    upscale's width product (62 -> 250, scale 0.248) is not.  XLA:CPU
    computes it as ``fma(x1, w1, round(x0 * w0))``, the port with each
    product rounded: JAX equals that fused emulation bit for bit, the port
    the unfused one, and the uint8 maps differ exactly where the two forms
    straddle a .5 boundary."""
    from retargetvid_tpu.ops.clustering import clustering_filter as j_cf
    from retargetvid_tpu.ops.resize import _resize_matrix_np
    from retargetvid_tpu.ops.resize import resize as jresize
    from retargetvid_tpu.ops.resize import resize_by_factor as j_by_factor
    from retargetvid_tpu.ops.threshold import threshold_saliency
    from retargetvid_tpu_torch.ops.clustering import clustering_filter
    from retargetvid_tpu_torch.ops.resize import (
        resize,
        resize_by_factor,
        round_half_up,
    )

    sm = np.asarray(threshold_saliency(jnp.asarray(
        _geometry_inputs()[0], jnp.float32), 90))
    kw = dict(min_cluster_size=5, select_sum=1, op_close=True, bridge=1,
              cc_iters=12)
    ref = np.asarray(jax.jit(functools.partial(
        j_cf, resize_factor=4.0, **kw))(jnp.asarray(sm)))
    out = clustering_filter(torch.from_numpy(sm.copy()), resize_factor=4.0,
                            **kw).numpy()

    small_in = round_half_up(resize_by_factor(
        torch.from_numpy(sm.copy()), 4.0, 'linear', channels_last=False))
    j_small_in = np.asarray(jax.jit(lambda x: jnp.floor(j_by_factor(
        x, 4.0, 'linear', channels_last=False) + 0.5))(jnp.asarray(sm)))
    assert np.array_equal(small_in.numpy(), j_small_in)     # exact downscale
    small = clustering_filter(torch.clamp(small_in, 0, 255),
                              **kw).numpy()                 # the 35x62 maps
    rows = _tap_sums(small, 1, _resize_matrix_np(35, 140, 'linear'),
                     fused=False)
    assert np.array_equal(rows, _tap_sums(
        small, 1, _resize_matrix_np(35, 140, 'linear'), fused=True))
    a_w = _resize_matrix_np(62, 250, 'linear')
    unfused = _tap_sums(rows, 2, a_w, fused=False)
    fused_w = _tap_sums(rows, 2, a_w, fused=True)
    j_up = np.asarray(jax.jit(lambda x: jresize(x, (140, 250), 'linear'))(
        jnp.asarray(small)))
    assert np.array_equal(j_up, fused_w)
    assert np.array_equal(resize(torch.from_numpy(small), (140, 250),
                                 'linear', channels_last=False).numpy(),
                          unfused)

    def u8(v):
        return np.clip(np.floor(v + np.float32(0.5)), 0, 255)

    assert np.array_equal(ref, u8(fused_w)) and np.array_equal(out,
                                                               u8(unfused))
    straddle = u8(unfused) != u8(fused_w)
    print(f'factor-4 roundtrip: {int((out != ref).sum())} of {ref.size} '
          f'uint8 values differ, all where the forms straddle a .5 '
          f'boundary ({int(straddle.sum())}), max 1 LSB')
    assert np.array_equal(out != ref, straddle)
    assert np.abs(out - ref).max() <= 1


def test_savgol_smooth():
    """Windows 5 (the smallest), 7, 31 and 59 (the widest of the 30 fps
    bank), a window outside the bank, and live lengths near the window."""
    from retargetvid_tpu.ops.filters import savgol_smooth as j_savgol
    from retargetvid_tpu_torch.ops.filters import savgol_smooth

    bank = tuple(range(5, 60, 2))
    rng = np.random.default_rng(8)
    rows = [(5, 7), (7, 40), (31, 33), (59, 61), (59, 120), (61, 100),
            (3, 50)]
    x = np.cumsum(rng.normal(0, 3, (len(rows), 128)), axis=1).astype(
        np.float32) + 100
    win = np.asarray([r[0] for r in rows], np.int32)
    n = np.asarray([r[1] for r in rows], np.int32)
    ref = np.asarray(jax.jit(jax.vmap(functools.partial(
        j_savgol, degree=2, window_bank=bank)))(
        jnp.asarray(x), jnp.asarray(n), jnp.asarray(win)))
    out = savgol_smooth(torch.from_numpy(x), torch.from_numpy(n),
                        torch.from_numpy(win), 2, bank).numpy()
    err = np.abs(out - ref).max()
    print(f'savgol: max |diff| {err:.3g} (atol 1e-2)')
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-2)
    assert np.array_equal(out[5:], x[5:])         # windows not in the bank
    assert not np.array_equal(out[0], x[0])


def test_butterworth_order2():
    """lp_order=2 at cutoff 1 (the ISM preset): one second-order section."""
    from retargetvid_tpu.ops.filters import (
        butter_lowpass_filter as j_butter,
    )
    from retargetvid_tpu_torch.ops.filters import (
        _butter_design,
        butter_lowpass_filter,
    )

    padlen, sections = _butter_design(1.0, 30.0, 2)
    assert padlen == 9 and len(sections) == 1
    rng = np.random.default_rng(9)
    x = np.cumsum(rng.normal(0, 3, (4, 96)), axis=1).astype(np.float32)
    n = np.asarray([96, 40, 10, 8], np.int32)        # 8 <= padlen: fallback
    ref = np.asarray(jax.jit(jax.vmap(functools.partial(
        j_butter, cutoff=1.0, fs=30.0, order=2)))(jnp.asarray(x),
                                                  jnp.asarray(n)))
    out = butter_lowpass_filter(torch.from_numpy(x), torch.from_numpy(n),
                                1.0, 30.0, 2).numpy()
    err = np.abs(out - ref).max()
    print(f'butterworth order 2: max |diff| {err:.3g} (atol 1e-2)')
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-2)


def test_smooth_segments_savgol():
    """``loess_filt=0`` with segments of 6 (< 10: the low-passed series),
    10 (window 7), 70 (window 59, the full bank), 40 and 24 frames."""
    from retargetvid_tpu.ops.filters import smooth_segments as j_smooth
    from retargetvid_tpu_torch.ops.filters import smooth_segments

    lens = [6, 10, 70, 40, 24]
    starts = np.cumsum([0] + lens[:-1]).astype(np.int32)
    ends = (starts + np.asarray(lens) - 1).astype(np.int32)
    s_pad, t_out = 8, 160
    ss = np.zeros(s_pad, np.int32)
    se = np.zeros(s_pad, np.int32)
    ss[:len(lens)], se[:len(lens)] = starts, ends
    rng = np.random.default_rng(10)
    dxi = np.cumsum(rng.normal(0, 2, t_out)).astype(np.float32) + 125
    dyi = np.cumsum(rng.normal(0, 1, t_out)).astype(np.float32) + 70
    kw = dict(fps=30.0, loess_filt=0, w_secs=2.0, degree=2, lp_filt=1,
              lp_cutoff=1.0, lp_order=2, max_len=t_out)
    ref = [np.asarray(v) for v in jax.jit(functools.partial(
        j_smooth, **kw))(jnp.asarray(dxi), jnp.asarray(dyi),
                         jnp.asarray(ss), jnp.asarray(se),
                         jnp.int32(len(lens)))]
    out = [v.numpy() for v in smooth_segments(
        torch.from_numpy(dxi), torch.from_numpy(dyi), torch.from_numpy(ss),
        torch.from_numpy(se), len(lens), **kw)]
    for name, a, b in zip(('dxs', 'dys', 'dxl', 'dyl'), out, ref):
        err = np.abs(a - b).max()
        print(f'smooth_segments savgol {name}: max |diff| {err:.3g} '
              f'(atol 1e-2)')
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-2)
    assert np.array_equal(out[0][:6], out[2][:6])     # short: low-passed
    assert not np.allclose(out[0][16:86], out[2][16:86], atol=1e-3)


def test_shift_time():
    from retargetvid_tpu.ops.boxes import shift_time as j_shift
    from retargetvid_tpu_torch.ops.boxes import shift_time

    boxes = np.random.default_rng(2).integers(0, 500, (64, 4)).astype(
        np.int32)
    for shift in (0, 1, 5, 63):
        ref = np.asarray(j_shift(jnp.asarray(boxes), shift))
        assert np.array_equal(shift_time(torch.from_numpy(boxes),
                                         shift).numpy(), ref), shift


def _banded_volume():
    """Saliency with low-saliency bands on all four sides (rows 0-11 and
    130-139 at most 6, columns 0-29 and 235-249 at most 6, one column of
    the right band brighter than the threshold for one frame)."""
    maps = _blobs(np.random.default_rng(6), 5, 140, 250, speckle=0.0)
    maps = np.maximum(maps, 20).astype(np.float32)
    low = np.random.default_rng(7).integers(0, 7, maps.shape)
    maps[:, :12], maps[:, 130:] = low[:, :12], low[:, 130:]
    maps[:, :, :30], maps[:, :, 235:] = low[:, :, :30], low[:, :, 235:]
    maps[2, 60, 245] = 50.0
    return maps


@pytest.mark.parametrize('t_border', [-1, 10, 255])
def test_border_detection(t_border):
    from retargetvid_tpu.ops.border import border_detection as j_border
    from retargetvid_tpu_torch.ops.border import border_detection

    maps = _banded_volume()
    ref = jax.jit(functools.partial(j_border, t_border=t_border, h_orig=360,
                                    w_orig=640))(jnp.asarray(maps))
    out = border_detection(torch.from_numpy(maps), t_border, 360, 640)
    got = {k: int(v) for k, v in out.items()}
    assert got == {k: int(v) for k, v in ref.items()}
    assert all(v.dtype == torch.int32 for v in out.values())
    print(f'borders t_border={t_border}: {got}')
    if t_border == 10:      # every band; the bright column stops the right
        assert got == {'border_t': 30, 'border_b': 25, 'border_l': 76,
                       'border_r': 10}
    if t_border == 255:     # nothing above: each side at its 45% cap
        assert got == {'border_t': 162, 'border_b': 162, 'border_l': 286,
                       'border_r': 286}


@pytest.mark.parametrize('mode,window', [(1, None), (1, 120), (2, 40)])
def test_coverage_score(mode, window):
    from retargetvid_tpu.ops.border import coverage_score as j_cvrg
    from retargetvid_tpu_torch.ops.border import coverage_score

    maps = _banded_volume()
    maps[3] = 0.0
    ref = [np.asarray(v) for v in j_cvrg(jnp.asarray(maps), mode, window)]
    out = [v.numpy() for v in coverage_score(torch.from_numpy(maps), mode,
                                             window)]
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    assert (out[1] == 0).all() if window is None else out[1].max() > 0.3


def _geometry_args(smaps, true_inds, seg, seg_sel):
    """The padding of ``run_geometry`` for the port's geometry_pipeline."""
    from retargetvid_tpu_torch.pipeline.geometry import (
        bucket_size,
        seg_bucket_size,
    )
    t_sel = len(true_inds)
    t_sel_pad = bucket_size(t_sel)
    s, s_pad = len(seg), seg_bucket_size(len(seg))
    vol = np.zeros((t_sel_pad,) + smaps.shape[1:], np.uint8)
    vol[:t_sel] = smaps
    ti = np.zeros(t_sel_pad, np.int64)
    ti[:t_sel] = true_inds
    ti[t_sel:] = ti[t_sel - 1] + np.arange(1, t_sel_pad - t_sel + 1)

    def pad_seg(arr, col):
        out = np.zeros(s_pad, np.int64)
        out[:s] = np.asarray(arr)[:, col]
        return torch.from_numpy(out)

    return (torch.from_numpy(vol), torch.arange(t_sel_pad) < t_sel, t_sel,
            torch.from_numpy(ti), pad_seg(seg, 0), pad_seg(seg, 1),
            pad_seg(seg_sel, 0), pad_seg(seg_sel, 1), s)


@pytest.fixture(scope='module')
def ism_geometry():
    from retargetvid_tpu.config import sc_init_crop_params
    from retargetvid_tpu.pipeline.geometry import run_geometry
    from retargetvid_tpu_torch.ops.boxes import calc_dest_size
    from retargetvid_tpu_torch.pipeline.geometry import (
        GeometryConfig,
        bucket_size,
        geometry_pipeline,
    )

    smaps, true_inds, seg, seg_sel, fc = _geometry_inputs()
    cp = sc_init_crop_params(use_best_settings=True)
    dest = calc_dest_size(640, 360, '1:3')
    kw = dict(fps=30.0, h_orig=360, w_orig=640, w_final=dest['w_final'],
              h_final=dest['h_final'])
    ref = run_geometry(smaps, true_inds, seg, seg_sel, cp, fc=fc,
                       fetch_maps=True, **kw)
    zero = torch.zeros((), dtype=torch.int32)
    out = geometry_pipeline(
        *_geometry_args(smaps, true_inds, seg, seg_sel), fc, zero, zero,
        zero, zero, cfg=GeometryConfig.from_crop_params(cp),
        t_out=bucket_size(fc), **kw)
    return ref, out, cp, fc, len(true_inds), kw


def test_ism_geometry_chain(ism_geometry):
    """The whole chain under ISM: boxes 0 px, centers and jump scores
    within 1e-3, at least one jump and one frozen span."""
    from retargetvid_tpu_torch.ops.temporal import frozen_spans

    ref, out, cp, fc, t_sel, _ = ism_geometry
    boxes = out['boxes'].numpy()[:fc]
    n_box = int((boxes != ref['boxes']).any(axis=1).sum())
    print(f'ISM geometry: {n_box} of {fc} boxes differ (tolerance 0)')
    assert n_box == 0
    for k in ('dx', 'dy', 'jumps'):
        err = np.abs(out[k].numpy()[:t_sel] - ref[k]).max()
        print(f'ISM geometry {k}: max |diff| {err:.3g} (atol 1e-3)')
        np.testing.assert_allclose(out[k].numpy()[:t_sel], ref[k], rtol=0,
                                   atol=1e-3)
    for k in ('dxi', 'dyi', 'dxs', 'dys'):
        err = np.abs(out[k].numpy()[:fc] - ref[k]).max()
        print(f'ISM geometry {k}: max |diff| {err:.3g} (atol 1e-2)')
        np.testing.assert_allclose(out[k].numpy()[:fc], ref[k], rtol=0,
                                   atol=1e-2)
    jumps = out['jumps'].numpy()[:t_sel]
    jump_inds = [i for i in range(1, t_sel) if jumps[i] < cp['foces_stab_t']]
    assert jump_inds == [i for i in range(1, t_sel)
                         if ref['jumps'][i] < cp['foces_stab_t']]
    spans = frozen_spans(jump_inds, fc_sel=t_sel, skip=cp['skip'], fps=30.0,
                         stab_secs=cp['foces_stab_s'])
    print(f'ISM geometry: jumps at {jump_inds}, frozen spans {spans}')
    assert len(jump_inds) >= 2 and spans
    # The factor-4 upscale's rounding (pinned above) moves single pixels
    # of the filtered maps by 1 LSB and no center.
    d = np.abs(out['smaps_filtered'].numpy()[:t_sel].astype(int)
               - ref['smaps_filtered'].astype(int))
    print(f'ISM geometry: {int((d > 0).sum())} of {d.size} filtered uint8 '
          f'values differ, max {d.max()} LSB')
    assert d.max() <= 1


def test_shift_time_padded_tail(ism_geometry):
    """``shift_time`` acts on the padded (t_out, 4) boxes as in JAX: with
    fc = 150 < t_out = 160 the last ``shift`` frames take padded rows'
    boxes, whose centers are 0: the left/top-clamped box, not the last
    real box that the reference's ``sc_shift_time`` repeats."""
    from retargetvid_tpu.ops.boxes import compute_crop_boxes, shift_time
    from retargetvid_tpu_torch.pipeline.geometry import geometry_boxes

    _, out, _, fc, _, kw = ism_geometry
    zero = torch.zeros((), dtype=torch.int32)
    dims = dict(h_orig=kw['h_orig'], w_orig=kw['w_orig'], h_process=140,
                w_process=250, w_final=kw['w_final'], h_final=kw['h_final'])
    shift = 5
    port = geometry_boxes(out, zero, zero, zero, zero, shift=shift,
                          **dims)['boxes'].numpy()
    j_boxes, _, _ = compute_crop_boxes(jnp.asarray(out['dxs'].numpy()),
                                       jnp.asarray(out['dys'].numpy()),
                                       **dims)
    ref = np.asarray(shift_time(j_boxes, shift))
    assert port.shape == (160, 4) and np.array_equal(port, ref)
    unshifted = out['boxes'].numpy()
    assert np.array_equal(port[:fc - shift], unshifted[shift:fc])
    zero_box = [0, 0, kw['w_final'], kw['h_final']]
    assert (port[fc - shift:fc] == zero_box).all()
    assert not (unshifted[fc - 1] == zero_box).all()
