"""The port's ``ShardedClipRunner`` and ``ShardedSaliency`` at dp 2 (two
gloo ranks on the CPU) against the JAX package's single-device programs.

- the clip runner on ``tests/test_sharded_clips.py``'s two 24-frame
  140x250 clips (a moving blob, a pick every 6 frames and the last) against
  JAX's ``FusedClipProgram`` per clip: boxes within 1 px, JAX's own bound;
- ``ShardedSaliency`` with ``per_chip`` 1 on 8 seeded 140x250 frames
  (``tests/test_train_parallel.py``'s) against JAX's
  ``SaliencyPredictor.predict``: within 1 LSB, more than 99.9% equal.

``TINY_UNISAL_CFG`` UNISAL, float32, its weights through ``convert``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_oneshot import models
from test_torch_parallel_mesh import ok_results, run_ranks

torch.set_num_threads(1)

KW = dict(fps=30.0, h_orig=360, w_orig=640, w_final=120, h_final=360)


def _clips():
    """``tests/test_sharded_clips.py``'s two clips."""
    h, w, n = 140, 250, 24
    yy, xx = np.mgrid[0:h, 0:w]

    def make_clip(phase):
        frames = np.zeros((n, h, w, 3), np.uint8)
        for t in range(n):
            cx = 40 + 2 * t + 20 * phase
            blob = 220 * np.exp(-(((yy - 70) ** 2 + (xx - cx) ** 2) / 300.0))
            frames[t] = blob[..., None].astype(np.uint8)
        selected = list(range(0, n, 6)) + [n - 1]
        return {'sal_frames': frames, 'selected': selected,
                'true_inds': selected,
                'segmentation': np.array([[0, n - 1]]),
                'segmentation_sel': np.array([[0, len(selected) - 1]]),
                'fc': n}

    return [make_clip(0), make_clip(1)]


def _frames():
    rng = np.random.default_rng(5)
    return rng.integers(0, 255, (8, 140, 250, 3)).astype(np.uint8)


def _rank_runs(rank, un, clips, cp, frames):
    from retargetvid_tpu_torch.parallel.mesh import make_mesh
    from retargetvid_tpu_torch.parallel.runner import (
        ShardedClipRunner,
        ShardedSaliency,
    )

    mesh = make_mesh(2, device='cpu')
    return {
        'clips': ShardedClipRunner(mesh, un).run_batch(clips, cp, **KW),
        'swapped': ShardedClipRunner(mesh, un).run_batch(clips[::-1], cp,
                                                         **KW),
        'maps': ShardedSaliency(mesh, un, per_chip=1).predict(frames),
    }


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    from retargetvid_tpu.config import sc_init_crop_params

    cp = sc_init_crop_params()
    _, _, ju, un_vars, _, un = models(f=2, d=16)
    port = ok_results(run_ranks(_rank_runs, 2,
                                tmp_path_factory.mktemp('clips'), un,
                                _clips(), cp, _frames()))
    return dict(cp=cp, port=port, jax=(ju, un_vars))


def test_clip_runner_matches_jax(runs):
    from retargetvid_tpu.pipeline.fused import FusedClipProgram

    ju, un_vars = runs['jax']
    single = FusedClipProgram(variables=un_vars, model=ju, dtype=jnp.float32)
    for i, clip in enumerate(_clips()):
        ref = single.run(jnp.asarray(clip['sal_frames']), clip['selected'],
                         clip['true_inds'], clip['segmentation'],
                         clip['segmentation_sel'], runs['cp'], fc=clip['fc'],
                         **KW)
        for r in runs['port']:
            res = r['clips'][i]
            assert res['boxes'].shape == (clip['fc'], 4)
            assert np.abs(res['boxes'] - ref['boxes']).max() <= 1
            # Outputs follow the clip, not the rank.
            np.testing.assert_array_equal(r['swapped'][1 - i]['boxes'],
                                          res['boxes'])
            np.testing.assert_allclose(res['mean_sal'], ref['mean_sal'],
                                       rtol=1e-5, atol=1e-4)


def test_saliency_matches_jax(runs):
    from retargetvid_tpu.pipeline.saliency import SaliencyPredictor

    ju, un_vars = runs['jax']
    frames = _frames()
    ref = SaliencyPredictor(variables=un_vars, model=ju,
                            chunk=8).predict(frames)
    a, b = (r['maps'] for r in runs['port'])
    np.testing.assert_array_equal(a, b)
    assert a.shape == ref.shape == (8, 140, 250) and a.dtype == np.uint8
    diff = np.abs(a.astype(int) - ref.astype(int))
    n_diff = int((diff > 0).sum())
    print(f'ShardedSaliency vs JAX: {n_diff} of {diff.size} pixels differ, '
          f'at most {diff.max()} LSB')
    assert diff.max() <= 1
    assert (diff == 0).mean() > 0.999
