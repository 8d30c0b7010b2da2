"""Batches of k x dp clips in the port's ``ShardedOneShot`` against JAX.

On a world of 1 (no process group), 2 and 4 clips against JAX's
``ShardedOneShot(make_mesh(1))``, which vmaps its body over the 4 clips:
picks and shots equal, probabilities within 1e-5, boxes within 1 px and
apart only where the uint8 saliency maps differ.  The four 72x128 clips of
52-64 frames share one 64-frame capacity, so the 2-clip batch pads as the
4-clip batch does.  The tiny TransNet (f=2, d=16, head biased) and
``TINY_UNISAL_CFG`` UNISAL, float32, the window plan, 1:3; the port's
weights are the JAX ones through ``convert``.  Two ranks:
``test_torch_parallel_batches_ranks.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_oneshot import models, saliency_maps
from test_torch_parallel_oneshot import _clip

torch.set_num_threads(1)

H, W, FPS = 72, 128, 30.0
FCS = (52, 60, 56, 64)


def _raws():
    rng = np.random.default_rng(11)
    return [_clip(rng, fc, H, W, phase)
            for fc, phase in zip(FCS, (0.0, 0.15, 0.05, 0.1))]


@pytest.fixture(scope='module')
def runs():
    from retargetvid_tpu.config import sc_init_crop_params
    from retargetvid_tpu.ops.boxes import calc_dest_size
    from retargetvid_tpu.parallel.mesh import make_mesh as jax_mesh
    from retargetvid_tpu.parallel.runner import ShardedOneShot as JSharded
    from retargetvid_tpu_torch.parallel.mesh import make_mesh
    from retargetvid_tpu_torch.parallel.runner import ShardedOneShot

    cp = sc_init_crop_params()
    cp['out_ratio'] = '1:3'
    dest = calc_dest_size(W, H, cp['out_ratio'])
    kw = dict(fps=FPS, w_final=dest['w_final'], h_final=dest['h_final'])
    raws = _raws()
    jt, tn_params, ju, un_vars, tn, un = models(f=2, d=16)
    ref = JSharded(jax_mesh(1), jt, tn_params, variables=un_vars, model=ju,
                   dtype=jnp.float32).run_batch(
        [jnp.asarray(r) for r in raws], cp, **kw)
    world1 = ShardedOneShot(make_mesh(1, device='cpu'), tn, un,
                            dtype=torch.float32)
    port = {k: world1.run_batch(raws[:k], cp, **kw) for k in (2, 4)}
    return dict(raws=raws, ref=ref, port=port, un=un, jax=(ju, un_vars))


@pytest.mark.parametrize('k', (2, 4))
def test_world_of_one_matches_jax(runs, k):
    """A world-1 batch of k clips: JAX's vmapped batch, clip by clip."""
    ju, un_vars = runs['jax']
    un = runs['un']
    for raw, got, want in zip(runs['raws'], runs['port'][k], runs['ref']):
        fc = raw.shape[0]
        assert not got['overrun'] and not want['overrun']
        assert (got['fc_sel'], got['n_segments']) == \
            (int(want['fc_sel']), int(want['n_segments']))
        np.testing.assert_allclose(got['probs'][:fc], want['probs'][:fc],
                                   rtol=0, atol=1e-5)
        assert got['boxes'].shape == (fc, 4)
        box_err = int(np.abs(got['boxes'] - want['boxes']).max())
        print(f'fc {fc}: boxes max |diff| {box_err} px')
        assert box_err <= 1
        if box_err:
            # Boxes may part by 1 px only where the uint8 maps differ.
            jmaps, tmaps = saliency_maps(ju, un_vars, un, raw,
                                         got['sel_idx'][:got['fc_sel']])
            assert (jmaps != tmaps).any()
