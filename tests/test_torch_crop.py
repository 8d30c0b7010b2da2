"""The single-video orchestrator: the port's ``smart_vid_crop``,
``run_geometry``, feature cache and renderers vs the JAX package's.

Inputs are those of ``test_torch_ingest_stream.py``: the 96-frame 180x320
mp4 with two hard cuts (and the same frames as a reference-format
``.pkl``), narrow TransNet and ``TINY_UNISAL_CFG`` UNISAL, float32, the
port on the CPU.  ICIP preset at 1:3.
"""

import pickle

import numpy as np
import pytest
import torch

from test_torch_geometry import _geometry_inputs
from test_torch_ingest_stream import (
    CUTS,
    FC,
    H,
    stream_frames,
    stream_models,
    write_clip_pickle,
    write_mp4,
)

torch.set_num_threads(1)

SCORE_KEYS = ('result', 'info', 'params', 'mean_sal_score',
              'mean_sal_score_t', 'coverage_score', 'coverage_score_t',
              'cuts_clust')


def _cp(**changes):
    from retargetvid_tpu_torch.config import sc_init_crop_params
    cp = sc_init_crop_params()
    cp['out_ratio'] = '1:3'
    cp.update(changes)
    return cp


@pytest.fixture(scope='module')
def clip(tmp_path_factory):
    d = tmp_path_factory.mktemp('crop')
    frames = stream_frames()
    return {'dir': d, 'mp4': write_mp4(d / '001.mp4', frames),
            'pkl': write_clip_pickle(d / '002.pkl', frames,
                                     trans_inds=[c - 1 for c in CUTS])}


@pytest.fixture(scope='module')
def fns():
    return stream_models()


@pytest.fixture(scope='module')
def crops(clip, fns):
    """Each side's ``smart_vid_crop`` on the mp4 and on the pickle."""
    from retargetvid_tpu.pipeline.crop import smart_vid_crop as jcrop
    from retargetvid_tpu_torch.pipeline.crop import smart_vid_crop

    jtn, jsal, ttn, tsal = fns
    out = {}
    for name in ('mp4', 'pkl'):
        path = str(clip[name])
        out[name] = (
            jcrop(path, _cp(), save_vid=False, transnet_fn=jtn,
                  saliency_fn=jsal),
            smart_vid_crop(path, _cp(), save_vid=False, transnet_fn=ttn,
                           saliency_fn=tsal, device='cpu'))
    return out


def _boxes_close(boxes, ref):
    boxes, ref = np.asarray(boxes), np.asarray(ref)
    assert boxes.shape == ref.shape == (FC, 4)
    err = int(np.abs(boxes - ref).max())
    print(f'boxes: max |diff| {err} px (tolerance 1; 0 expected)')
    assert err <= 1


@pytest.mark.parametrize('name', ['mp4', 'pkl'])
def test_smart_vid_crop(crops, name):
    (jvd, jres), (vd, res) = crops[name]
    _boxes_close(vd['bbs'], jvd['bbs'])
    assert res['result'] == 'smart cropped'
    for k in SCORE_KEYS:
        assert res[k] == jres[k], k
    assert [k for k in res if k.startswith('t_')] == \
        [k for k in jres if k.startswith('t_')]
    assert len(vd['segmentation']) == len(CUTS) + 1
    for k in ('fbb_w', 'fbb_h', 'border_t', 'border_b', 'border_l',
              'border_r', 'w_final', 'h_final', 'conversion_mode'):
        assert vd[k] == jvd[k], k


@pytest.mark.parametrize('gate', ['exit_on_spread_sal', 'exit_on_low_cvrg'])
def test_pad_gates(crops, gate):
    """Each pad gate alone pads the clip, with JAX's scores and strings."""
    from retargetvid_tpu.pipeline.crop import smart_vid_crop as jcrop
    from retargetvid_tpu_torch.pipeline.crop import smart_vid_crop

    (jvd, _), (vd, _) = crops['pkl']
    cp = _cp(**{gate: True, 't_sal': 1, 't_cvrg': 0.5})
    _, jres = jcrop('x.pkl', dict(cp), save_vid=False, vid_data=dict(jvd))
    _, res = smart_vid_crop('x.pkl', dict(cp), save_vid=False,
                            vid_data=dict(vd), device='cpu')
    assert res['result'] == jres['result'] == 'padded'
    for k in SCORE_KEYS:
        if isinstance(jres[k], float):
            assert res[k] == pytest.approx(jres[k], rel=1e-6), k
        else:
            assert res[k] == jres[k], k


def test_plots(crops, tmp_path):
    """``plots_fn`` draws the signal plot and the smoothing preview, as in
    JAX."""
    from retargetvid_tpu.pipeline.crop import smart_vid_crop as jcrop
    from retargetvid_tpu_torch.pipeline.crop import smart_vid_crop

    (jvd, _), (vd, _) = crops['pkl']
    for side, fn, v, kw in (('jax', jcrop, jvd, {}),
                            ('port', smart_vid_crop, vd, {'device': 'cpu'})):
        fn('x.pkl', _cp(), save_vid=False, vid_data=dict(v),
           plots_fn=str(tmp_path / f'{side}.png'), **kw)
        assert (tmp_path / f'{side}.png').stat().st_size > 0
        assert (tmp_path / f'{side}_signals.png').stat().st_size > 0


def test_feature_cache(clip, fns, crops, tmp_path):
    """The port writes a cache it reads back without models, and reads a
    cache the JAX package wrote (both give the boxes of a full run)."""
    from retargetvid_tpu.pipeline.crop import smart_vid_crop as jcrop
    from retargetvid_tpu_torch.pipeline.crop import smart_vid_crop

    jtn, jsal, ttn, tsal = fns
    (jvd, _), (vd, _) = crops['mp4']
    path = str(clip['mp4'])
    port_dir, jax_dir = tmp_path / 'port', tmp_path / 'jax'
    smart_vid_crop(path, _cp(), save_vid=False, temp_path=str(port_dir),
                   transnet_fn=ttn, saliency_fn=tsal, device='cpu')
    jcrop(path, _cp(), save_vid=False, temp_path=str(jax_dir),
          transnet_fn=jtn, saliency_fn=jsal)
    for cache_dir, want in ((port_dir, vd), (jax_dir, jvd)):
        assert (cache_dir / '001.pkl').is_file()
        again, res = smart_vid_crop(path, _cp(), save_vid=False,
                                    temp_path=str(cache_dir), device='cpu')
        assert np.array_equal(again['bbs'], want['bbs'])
        assert 't__read' in res


def test_load_vid_data_reference_layout(tmp_path):
    """A cache in the reference's (H, W, T) layout loads as (T, H, W)."""
    from retargetvid_tpu.pipeline.ingest import load_vid_data as jload
    from retargetvid_tpu_torch.pipeline.ingest import load_vid_data

    smaps = np.random.default_rng(0).integers(0, 255, (6, 7, 5)).astype(
        np.uint8)
    with open(tmp_path / 'ref.pkl', 'wb') as fp:
        pickle.dump({'smaps': smaps, 'fc': 5}, fp)
    vd, ref = load_vid_data(tmp_path / 'ref.pkl'), jload(tmp_path / 'ref.pkl')
    assert vd['layout'] == ref['layout'] == 'thw'
    assert vd['smaps'].shape == (5, 6, 7)
    assert np.array_equal(vd['smaps'], ref['smaps'])


def test_render_cropped_pickle(clip, crops, tmp_path):
    from retargetvid_tpu.pipeline.render import (
        render_cropped_pickle as jrender,
    )
    from retargetvid_tpu_torch.pipeline.render import render_cropped_pickle

    _, (vd, _) = crops['pkl']
    boxes = np.asarray(vd['bbs'])
    outs = [fn(clip['pkl'], boxes, tmp_path / f'{name}.pkl')
            for name, fn in (('port', render_cropped_pickle),
                             ('jax', jrender))]
    got, ref = (pickle.load(open(p, 'rb')) for p in outs)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert np.array_equal(np.asarray(got[k]), np.asarray(ref[k])), k
    assert got['frames'].shape == (FC, H, got['w'], 3)


def test_renderers(clip, crops, tmp_path):
    """Cropped, padded and demo videos: the frame counts and sizes of
    JAX's."""
    from retargetvid_tpu.pipeline import render as jrender
    from retargetvid_tpu_torch.io.video import probe_video
    from retargetvid_tpu_torch.pipeline import render

    (jvd, _), (vd, _) = crops['mp4']
    geo = dict(vd['geometry'], smaps_filtered=np.asarray(vd['smaps']))
    jgeo = dict(jvd['geometry'], smaps_filtered=np.asarray(jvd['smaps']))
    src = clip['mp4']
    dims = {}
    for side, mod, v, g in (('port', render, vd, geo),
                            ('jax', jrender, jvd, jgeo)):
        d = tmp_path / side
        d.mkdir()
        n = (mod.render_cropped(src, v['bbs'], d / 'crop.mp4'),
             mod.render_padded(src, d / 'pad.mp4', v['w_final'],
                               v['h_final']),
             mod.render_demo(src, v, g, d / 'demo.mp4'))
        dims[side] = (n, [tuple(probe_video(d / f)[k] for k in (
            'frame_count', 'width', 'height'))
            for f in ('crop.mp4', 'pad.mp4', 'demo.mp4')])
    assert dims['port'] == dims['jax']
    assert dims['port'][0] == (FC, FC, FC)
    assert dims['port'][1][0] == (FC, vd['w_final'], H)


def test_run_geometry():
    """The host entry on a seeded volume, ISM preset: boxes exact, series
    within 2**-15 (3.05e-5, one float32 ulp at 64-128: the error the ported
    ISM chain shows against JAX), the filtered maps fetched."""
    from retargetvid_tpu.pipeline.geometry import run_geometry as jrun
    from retargetvid_tpu_torch.config import sc_init_crop_params
    from retargetvid_tpu_torch.ops.boxes import calc_dest_size
    from retargetvid_tpu_torch.pipeline.geometry import run_geometry

    smaps, true_inds, seg, seg_sel, fc = _geometry_inputs()
    cp = sc_init_crop_params(use_best_settings=True)
    dest = calc_dest_size(640, 360, '1:3')
    kw = dict(fps=30.0, h_orig=360, w_orig=640, w_final=dest['w_final'],
              h_final=dest['h_final'], fc=fc, fetch_maps=True)
    ref = jrun(smaps, true_inds, seg, seg_sel, cp, **kw)
    out = run_geometry(smaps, true_inds, seg, seg_sel, cp, device='cpu',
                       **kw)
    assert sorted(out) == sorted(ref)
    assert np.array_equal(out['boxes'], ref['boxes'])
    assert out['boxes'].shape == (fc, 4)
    assert int(out['fbb_w']) == int(ref['fbb_w'])
    for k in ('dx', 'dy', 'jumps', 'dxi', 'dyi', 'dxs', 'dys', 'dxl', 'dyl'):
        assert out[k].shape == ref[k].shape, k
        err = float(np.abs(out[k] - ref[k]).max())
        print(f'run_geometry {k}: max |diff| {err:.3g} (atol 2**-15)')
        np.testing.assert_allclose(out[k], ref[k], rtol=0, atol=2 ** -15)
    assert out['smaps_filtered'].shape == smaps.shape
