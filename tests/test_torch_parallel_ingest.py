"""The port's ``read_video_structure`` against the JAX package's on the
170-frame 360x640 mp4 of ``tests/test_cli_benchmark_sharded.py``: the
whole-buffer shot detection (``read_batch`` 2000) and the overlap-stitched
read batches (``read_batch`` 48), with that test's frame-difference
detector and with the tiny TransNet through ``IngestShotProgram`` (which
the streamed path runs as its ``TransNetPredictor``).

``fc``, picks, ``true_inds`` and both scene tables are equal.  The 140x250
saliency frames are the port's resize, pinned in
``tests/test_torch_resize.py::test_saliency_ingest_resize``: XLA:CPU fuses
one multiply-add of the width product, so JAX's uint8 values differ from
the port's by 1 exactly where the two float32 forms straddle a .5
boundary; the port's whole and streamed volumes are equal.
"""

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip('cv2')

from test_cli_benchmark_sharded import _write_clip  # noqa: E402
from test_torch_ingest_stream import decode  # noqa: E402
from test_torch_oneshot import models  # noqa: E402
from test_torch_resize import _tap_sums  # noqa: E402

torch.set_num_threads(1)

N = 170


def mock_tn(frames):
    """``tests/test_cli_benchmark_sharded.py``'s detector: a cut where the
    mean absolute difference to the next frame exceeds 20 (zero frames
    excluded)."""
    f = np.asarray(frames).astype(np.float32)
    probs = np.zeros(len(f), np.float32)
    if len(f) > 1:
        d = np.abs(f[1:] - f[:-1]).mean(axis=(1, 2, 3))
        live = f[:-1].max(axis=(1, 2, 3)) > 2
        probs[1:] = np.where((d > 20) & live, 0.9, 0.0)
    return probs


@pytest.fixture(scope='module')
def video(tmp_path_factory):
    path = tmp_path_factory.mktemp('ingest') / 'long.mp4'
    _write_clip(path, N)
    return path


def _straddle(raw, hw):
    """Where the port's unfused and XLA's fused width product round to
    different uint8 values (``test_torch_resize``)."""
    from retargetvid_tpu.ops.resize import _resize_matrix_np

    rows = _tap_sums(raw, 1, _resize_matrix_np(raw.shape[1], hw[0],
                                               'linear'), fused=False)
    a_w = _resize_matrix_np(raw.shape[2], hw[1], 'linear')

    def u8(v):
        return np.clip(np.floor(v + np.float32(0.5)), 0, 255).astype(np.uint8)

    return (u8(_tap_sums(rows, 2, a_w, fused=False))
            != u8(_tap_sums(rows, 2, a_w, fused=True)))


@pytest.mark.parametrize('detector', ['mock', 'transnet'])
def test_read_video_structure_matches_jax(video, detector):
    from retargetvid_tpu.config import sc_init_crop_params
    from retargetvid_tpu.models.transnet import IngestShotProgram as JIngest
    from retargetvid_tpu.pipeline.ingest import read_video_structure as jread
    from retargetvid_tpu_torch.models.transnet import IngestShotProgram
    from retargetvid_tpu_torch.pipeline.ingest import read_video_structure

    if detector == 'mock':
        fns = (mock_tn, mock_tn)
    else:
        jt, tn_params, _, _, tn, _ = models(f=2, d=16)
        fns = (JIngest(jt, tn_params, sal_hw=(140, 250)),
               IngestShotProgram(tn, sal_hw=(140, 250), device='cpu'))
    outs = {}
    for read_batch in (2000, 48):
        cp = sc_init_crop_params()
        cp['read_batch'] = read_batch
        ref = jread(str(video), cp, fns[0])
        out = read_video_structure(str(video), cp, fns[1], device='cpu')
        assert out.keys() == ref.keys()
        assert out['fc'] == ref['fc'] == N
        assert (out['fps'], out['h_orig'], out['w_orig']) == \
            (ref['fps'], ref['h_orig'], ref['w_orig'])
        for k in ('selected', 'true_inds'):
            assert list(out[k]) == list(ref[k]), k
        for k in ('segmentation', 'segmentation_sel'):
            np.testing.assert_array_equal(np.asarray(out[k]),
                                          np.asarray(ref[k]), err_msg=k)
        assert out['sal_frames'].dtype == np.uint8
        assert out['sal_frames'].shape == ref['sal_frames'].shape == \
            (N, 140, 250, 3)
        outs[read_batch] = (out, ref)
    (whole, jwhole), (streamed, jstreamed) = outs[2000], outs[48]
    np.testing.assert_array_equal(streamed['sal_frames'],
                                  whole['sal_frames'])
    np.testing.assert_array_equal(jstreamed['sal_frames'],
                                  jwhole['sal_frames'])
    straddle = _straddle(decode(video), (140, 250))
    assert ((whole['sal_frames'] != jwhole['sal_frames']) == straddle).all()
    assert int(np.abs(whole['sal_frames'].astype(int)
                      - jwhole['sal_frames'].astype(int)).max()) <= 1
