"""The streaming ingest: the port's ``read_and_segment_video``,
``segment_chunks`` and ``ingest_pickle`` vs the JAX package's.

The clip is a 96-frame 180x320 mp4 (written with ``cv2``, ``mp4v``, 30
fps) with two hard cuts: a blob moving over a background drawn anew at
frames 32 and 64.  Both sides decode the same file.  TransNet is narrow
(``f=2``, ``d=16``, head biased) and UNISAL is ``TINY_UNISAL_CFG``, both
float32 with the JAX weights carried across by ``convert``; the shot
detector each side gets is its TransNet predictor's probabilities, raised
to 1 where a frame-difference test finds a hard cut on the 27x48 frames,
so the cuts reach sampling and scenes on both sides.
"""

import pickle

import cv2
import numpy as np
import pytest
import torch

from test_torch_oneshot import models

torch.set_num_threads(1)

FC, H, W, FPS = 96, 180, 320, 30.0
CUTS = (32, 64)
#: Saliency chunk of both predictors (small: the picks per read batch).
CHUNK = 8


def stream_frames(fc=FC, h=H, w=W, cuts=CUTS, seed=0):
    """A blob moving over seeded noise drawn anew at each cut."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    frames = np.zeros((fc, h, w, 3), np.uint8)
    base = rng.integers(0, 40, (h, w, 3))
    for t in range(fc):
        if t in cuts:
            base = rng.integers(0, 40, (h, w, 3)) + 60 * cuts.index(t) + 60
        cx = w * (0.2 + 0.6 * t / fc)
        cy = h * (0.5 + 0.2 * np.sin(t / 9.0))
        blob = 200 * np.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2) / 500.0))
        frames[t] = np.clip(base + blob[..., None], 0, 255).astype(np.uint8)
    return frames


def write_mp4(path, frames, fps=FPS):
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*'mp4v'),
                             fps, (frames.shape[2], frames.shape[1]))
    assert writer.isOpened(), 'cv2 cannot encode mp4v here'
    for f in frames:
        writer.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    writer.release()
    return path


def decode(path):
    """All frames of ``path`` as RGB uint8, by the port's reader."""
    from retargetvid_tpu_torch.io.video import VideoReader
    reader = VideoReader(path)
    try:
        return np.stack(list(reader.frames()))
    finally:
        reader.stop()


def cut_profile(context):
    """1 on the last frame of a shot: a mean absolute difference above 20
    to the next frame, both frames not all zero (the zero overlap and tail
    are not cuts)."""
    x = np.asarray(context).astype(np.float32)
    d = np.abs(x[1:] - x[:-1]).mean(axis=(1, 2, 3))
    live = x.reshape(len(x), -1).max(axis=1) > 0
    hit = (d > 20) & live[1:] & live[:-1]
    return np.concatenate([hit, [False]]).astype(np.float32)


class Detector:
    """A predictor's probabilities raised by :func:`cut_profile`; keeps
    the predictor's own outputs per call."""

    def __init__(self, predictor):
        self.predictor = predictor
        self.calls = []

    def __call__(self, context):
        p = np.asarray(self.predictor(context), np.float32)
        self.calls.append(p)
        return np.maximum(p, cut_profile(context))


def stream_models():
    """(JAX transnet_fn, JAX saliency_fn, port transnet_fn, port
    saliency_fn) with the same weights; the port's on the CPU."""
    from retargetvid_tpu.models.transnet import TransNetPredictor as JPred
    from retargetvid_tpu.pipeline.saliency import SaliencyPredictor as JSal
    from retargetvid_tpu_torch.models.transnet import TransNetPredictor
    from retargetvid_tpu_torch.pipeline.saliency import SaliencyPredictor

    jt, tn_params, ju, un_vars, tn, un = models(f=2, d=16)
    return (Detector(JPred(jt, tn_params)),
            JSal(variables=un_vars, model=ju, chunk=CHUNK).predict,
            Detector(TransNetPredictor(tn, device='cpu')),
            SaliencyPredictor(un, chunk=CHUNK, device='cpu').predict)


@pytest.fixture(scope='module')
def mp4(tmp_path_factory):
    return write_mp4(tmp_path_factory.mktemp('stream') / '001.mp4',
                     stream_frames())


@pytest.fixture(scope='module')
def fns():
    return stream_models()


def _params(read_batch, fix_tail):
    from retargetvid_tpu_torch.config import sc_init_crop_params
    cp = sc_init_crop_params()
    cp['read_batch'] = read_batch
    cp['tpu_fix_batch_tail'] = fix_tail
    return cp


def _smaps_close(a, b):
    """uint8 maps within 1 LSB on at most 0.05% of values."""
    d = np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int))
    print(f'smaps: {int((d > 0).sum())} of {d.size} values differ, max '
          f'{d.max()} LSB')
    assert d.max() <= 1 and (d > 0).mean() <= 5e-4


def _structure_equal(vd, ref):
    for k in ('true_inds', 'inds_to_orig', 'fc', 'fc_sel', 'fr', 'h_orig',
              'w_orig', 'h_process', 'w_process'):
        assert vd[k] == ref[k], k
    for k in ('segmentation', 'segmentation_sel'):
        assert np.array_equal(np.asarray(vd[k]), np.asarray(ref[k])), k


@pytest.mark.parametrize('read_batch,fix_tail', [
    (40, False), (40, True), (2000, False), (2000, True)])
def test_read_and_segment_video(mp4, fns, read_batch, fix_tail):
    from retargetvid_tpu.pipeline.ingest import read_and_segment_video as jrs
    from retargetvid_tpu_torch.pipeline.ingest import read_and_segment_video

    jtn, jsal, ttn, tsal = fns
    jtn.calls.clear()
    ttn.calls.clear()
    cp = _params(read_batch, fix_tail)
    ref = jrs(str(mp4), dict(cp), jtn, jsal)
    vd = read_and_segment_video(str(mp4), dict(cp), ttn, tsal, device='cpu')
    _structure_equal(vd, ref)
    assert vd['fc'] == FC
    assert len(vd['segmentation']) == len(CUTS) + 1
    assert [s[0] for s in vd['segmentation'][1:]] == list(CUTS)
    assert len(ttn.calls) == len(jtn.calls) == -(-FC // read_batch)
    for p, q in zip(ttn.calls, jtn.calls):
        err = np.abs(p - q).max()
        print(f'probs: max |diff| {err:.3g} (atol 1.2e-7)')
        np.testing.assert_allclose(p, q, rtol=0, atol=1.2e-7)
    _smaps_close(vd['smaps'], ref['smaps'])

    # The last selected map of each read batch: zero under the quirk.
    ends = [vd['inds_to_orig'][min(e, FC) - 1]
            for e in range(read_batch, FC + read_batch, read_batch)]
    smaps = np.asarray(vd['smaps'])
    assert (not smaps[ends].any()) == (not fix_tail)
    if fix_tail:
        assert all(smaps[i].any() for i in ends)


def test_segment_chunks_equals_file_path(mp4, fns):
    """In-memory chunks through ``segment_chunks`` give the file path's
    ``vid_data``."""
    from retargetvid_tpu_torch.io.video import probe_video
    from retargetvid_tpu_torch.pipeline.ingest import (
        read_and_segment_video,
        segment_chunks,
    )

    _, _, ttn, tsal = fns
    cp = _params(40, False)
    frames = decode(mp4)
    vd_file = read_and_segment_video(str(mp4), dict(cp), ttn, tsal,
                                     device='cpu')
    chunks = ((frames[s:s + 30], s) for s in range(0, FC, 30))
    vd_mem = segment_chunks(probe_video(mp4), chunks, dict(cp), ttn, tsal,
                            device='cpu')
    _structure_equal(vd_mem, vd_file)
    assert np.array_equal(vd_mem['smaps'], vd_file['smaps'])


def write_clip_pickle(path, frames, fps=FPS, trans_inds=()):
    with open(path, 'wb') as fp:
        pickle.dump({'fr': fps, 'frame_count': len(frames),
                     'w': frames.shape[2], 'h': frames.shape[1],
                     'frames': frames, 'trans_inds': list(trans_inds)}, fp)
    return path


@pytest.mark.parametrize('fix_tail', [False, True])
def test_ingest_pickle(tmp_path, fns, fix_tail):
    from retargetvid_tpu.pipeline.ingest import ingest_pickle as jingest
    from retargetvid_tpu_torch.pipeline.ingest import ingest_pickle

    _, jsal, _, tsal = fns
    pkl = write_clip_pickle(tmp_path / 'clip.pkl', stream_frames(),
                            trans_inds=[c - 1 for c in CUTS])
    cp = _params(2000, fix_tail)
    ref = jingest(str(pkl), dict(cp), jsal)
    vd = ingest_pickle(str(pkl), dict(cp), tsal, device='cpu')
    _structure_equal(vd, ref)
    assert [s[0] for s in vd['segmentation'][1:]] == list(CUTS)
    _smaps_close(vd['smaps'], ref['smaps'])
    assert (not np.asarray(vd['smaps'])[-1].any()) == (not fix_tail)


def _good_vid_data():
    return {'fc': 10, 'fc_sel': 3, 'true_inds': [0, 6, 9],
            'inds_to_orig': [0] * 6 + [1] * 3 + [2],
            'smaps': np.zeros((3, 4, 4), np.uint8),
            'segmentation': np.array([[0, 9]]),
            'segmentation_sel': np.array([[0, 2]])}


SANITY_BREAKS = {
    'fc exceeds container frame count': lambda vd: vd.update(
        fc=11, inds_to_orig=vd['inds_to_orig'] + [2],
        segmentation=np.array([[0, 10]])),
    'fc_sel != len(true_inds)': lambda vd: vd.update(true_inds=[0, 6]),
    'fc != len(inds_to_orig)': lambda vd: vd.update(
        inds_to_orig=vd['inds_to_orig'][1:]),
    'fc_sel != smaps frames': lambda vd: vd.update(
        smaps=np.zeros((4, 4, 4), np.uint8)),
    'segmentation end mismatch': lambda vd: vd.update(
        segmentation=np.array([[0, 8]])),
    'segmentation_sel end mismatch': lambda vd: vd.update(
        segmentation_sel=np.array([[0, 1]])),
    'inds_to_orig tail mismatch': lambda vd: vd.update(
        inds_to_orig=[0] * 6 + [1] * 4),
}


@pytest.mark.parametrize('problem', sorted(SANITY_BREAKS))
def test_sanity_checks_raise(problem):
    """Each of the seven invariants raises alone, with JAX's message."""
    from retargetvid_tpu.pipeline.ingest import _sanity_checks as jchecks
    from retargetvid_tpu_torch.pipeline.ingest import _sanity_checks

    _sanity_checks(_good_vid_data(), 10)
    vd = _good_vid_data()
    SANITY_BREAKS[problem](vd)
    for checks in (_sanity_checks, jchecks):
        with pytest.raises(ValueError) as exc:
            checks(vd, 10)
        assert str(exc.value) == ('ingest sanity checks failed: '
                                  + problem)
