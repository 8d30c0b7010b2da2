"""The port's ``ShardedOneShot`` at dp 2 (two gloo ranks on the CPU)
against the JAX package's ``OneShotClipProgram`` per clip.

The clips, models and crop parameters are ``tests/test_sharded_oneshot.py``'s:
52 and 60 frames at 90x160 (one 64-frame capacity, so the 52-frame clip
runs padded with its live count), the tiny TransNet (f=2, d=16) with its
head biased to ``[5, -5]``, ``TINY_UNISAL_CFG`` UNISAL, float32, the window
plan, 1:3.  The weights reach the port through ``convert``.  Each rank runs
the batch, the batch swapped, and the batch with the head flipped to
``[-5, 5]`` (a cut on every frame, past ``s_pad``).
"""

import copy

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_oneshot import models
from test_torch_parallel_mesh import ok_results, run_ranks

torch.set_num_threads(1)

H, W, FPS = 90, 160, 30.0


def _clip(rng, fc, h, w, phase):
    """``tests/test_sharded_oneshot.py:_clip``."""
    yy, xx = np.mgrid[0:h, 0:w]
    frames = np.zeros((fc, h, w, 3), np.uint8)
    for t in range(fc):
        cx = w * (0.2 + 0.6 * t / fc) if t < fc // 2 else w * (0.6 + phase)
        blob = 225 * np.exp(-(((yy - h * 0.5) ** 2 +
                               (xx - cx) ** 2) / 250.0))
        frames[t] = np.clip(blob[..., None] +
                            (10 if t < fc // 2 else 50 + 40 * phase), 0,
                            255).astype(np.uint8)
    return frames


def _rank_batches(rank, tn, un, raws, cp, kw):
    from retargetvid_tpu_torch.kernels.build import LAUNCHES
    from retargetvid_tpu_torch.parallel.mesh import make_mesh
    from retargetvid_tpu_torch.parallel.runner import ShardedOneShot

    runner = ShardedOneShot(make_mesh(2, device='cpu'), tn, un,
                            dtype=torch.float32)
    out = {'batch': runner.run_batch(raws, cp, **kw),
           'swapped': runner.run_batch(raws[::-1], cp, **kw)}
    with torch.no_grad():
        runner.tn_model.dense2.bias.copy_(torch.tensor([-5.0, 5.0]))
    out['cut'] = runner.run_batch(raws, cp, **kw)
    out['launches'] = LAUNCHES['saliency_postprocess']
    return out


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    from retargetvid_tpu.config import sc_init_crop_params
    from retargetvid_tpu.ops.boxes import calc_dest_size

    cp = sc_init_crop_params()
    cp['out_ratio'] = '1:3'
    dest = calc_dest_size(W, H, cp['out_ratio'])
    kw = dict(fps=FPS, w_final=dest['w_final'], h_final=dest['h_final'])
    rng = np.random.default_rng(11)
    raws = [_clip(rng, 52, H, W, 0.0), _clip(rng, 60, H, W, 0.15)]
    jt, tn_params, ju, un_vars, tn, un = models(f=2, d=16)
    port = ok_results(run_ranks(_rank_batches, 2,
                                tmp_path_factory.mktemp('oneshot'), tn, un,
                                raws, cp, kw))
    return dict(cp=cp, kw=kw, raws=raws, port=port, models=(tn, un),
                jax=(jt, tn_params, ju, un_vars))


def test_matches_jax_per_clip(runs):
    """Each rank returns the whole batch; each clip's picks, shots and
    boxes are JAX's single-clip program's, probabilities within 1e-5."""
    from retargetvid_tpu.pipeline.oneshot import OneShotClipProgram as JProg

    jt, tn_params, ju, un_vars = runs['jax']
    single = JProg(jt, tn_params, variables=un_vars, model=ju,
                   dtype=jnp.float32)
    for raw, a, b in zip(runs['raws'], *(r['batch'] for r in runs['port'])):
        ref = single.run(jnp.asarray(raw), runs['cp'], **runs['kw'])
        fc = raw.shape[0]
        for res in (a, b):
            assert not res['overrun']
            assert res['fc_sel'] == ref['fc_sel']
            assert res['n_segments'] == ref['n_segments']
            np.testing.assert_allclose(res['probs'][:fc], ref['probs'][:fc],
                                       rtol=1e-5, atol=1e-5)
            assert res['boxes'].shape == (fc, 4)
            np.testing.assert_array_equal(res['boxes'], ref['boxes'])
    # On the CPU the postprocess is the plain version: no kernel launch.
    assert [r['launches'] for r in runs['port']] == [0, 0]


def test_outputs_follow_the_clip(runs):
    """Swapping the batch's clips swaps the outputs: each clip's result
    follows the clip, not the rank that ran it."""
    for r in runs['port']:
        for got, want in zip(r['swapped'], r['batch'][::-1]):
            assert got.keys() == want.keys()
            for k in got:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_overrun_flagged(runs):
    """A cut on every frame picks every frame, past the 32 picks the
    program holds: it still completes (its gathers clamp, as XLA's do) and
    flags every clip for the caller's streaming fallback."""
    for r in runs['port']:
        assert [o['overrun'] for o in r['cut']] == [True, True]
        assert [o['fc_sel'] for o in r['cut']] == [52, 60]


def test_single_clip_program_refuses_the_overrun(runs):
    """The same clip through ``OneShotClipProgram`` completes on the device
    and is refused at ``collect`` with the error the CLI falls back on."""
    from retargetvid_tpu_torch.pipeline.oneshot import OneShotClipProgram

    tn, un = copy.deepcopy(runs['models'])
    with torch.no_grad():
        tn.dense2.bias.copy_(torch.tensor([-5.0, 5.0]))
    program = OneShotClipProgram(tn, un, dtype=torch.float32, device='cpu')
    with pytest.raises(ValueError, match='60 picks > t_sel_pad=32'):
        program.run(runs['raws'][1], runs['cp'], **runs['kw'])


@pytest.mark.slow
@pytest.mark.mesh
def test_matches_jax_sharded_oneshot(runs):
    """The port's two ranks against JAX's ``ShardedOneShot`` on a 2-device
    virtual mesh: boxes bit for bit."""
    from retargetvid_tpu.parallel.mesh import make_mesh
    from retargetvid_tpu.parallel.runner import ShardedOneShot

    jt, tn_params, ju, un_vars = runs['jax']
    ref = ShardedOneShot(make_mesh(2), jt, tn_params, variables=un_vars,
                         model=ju, dtype=jnp.float32).run_batch(
        [jnp.asarray(r) for r in runs['raws']], runs['cp'], **runs['kw'])
    for r in runs['port']:
        for got, want in zip(r['batch'], ref):
            np.testing.assert_array_equal(got['boxes'], want['boxes'])
            assert (got['fc_sel'], got['n_segments']) == \
                (want['fc_sel'], want['n_segments'])
