"""Batches of k x dp clips on two gloo ranks (the harness of
``test_torch_parallel_mesh.py``).

- ``ShardedOneShot`` on 4 clips: each rank runs its contiguous block of 2
  (where JAX's ``P('dp')`` puts them) and returns all 4 in input order,
  each equal to the single-clip program at its own frame count;
- ``ShardedClipRunner`` on 4 clips equals its two dp-sized batches;
- a batch of 3 raises in both.

The clips are ``test_torch_parallel_batches.py``'s; the tiny TransNet (f=2,
d=16, head biased) and ``TINY_UNISAL_CFG`` UNISAL with seeded weights,
float32, the window plan, 1:3.  JAX parity of the batches is held on a
world of 1 in ``test_torch_parallel_batches.py``.
"""

import numpy as np
import pytest
import torch

from test_torch_parallel_batches import FPS, H, W, _raws
from test_torch_parallel_clips import KW as CLIP_KW
from test_torch_parallel_clips import _clips as runner_clips
from test_torch_parallel_mesh import ok_results, run_ranks

torch.set_num_threads(1)


def _models():
    from conftest import TINY_UNISAL_CFG
    from retargetvid_tpu_torch.models.init import seeded_init_
    from retargetvid_tpu_torch.models.transnet import TransNetV1
    from retargetvid_tpu_torch.models.unisal import UNISAL

    tn = seeded_init_(TransNetV1(f=2, d=16), 0)
    with torch.no_grad():
        tn.dense2.bias.copy_(torch.tensor([5.0, -5.0]))
    return tn, seeded_init_(UNISAL(**TINY_UNISAL_CFG), 1)


def _runner_clips():
    """``test_torch_parallel_clips``'s two clips and the same two mirrored
    left to right."""
    clips = runner_clips()
    for c in runner_clips():
        clips.append(dict(c, sal_frames=np.ascontiguousarray(
            c['sal_frames'][:, :, ::-1])))
    return clips


def _rank_batches(rank, tn, un, raws, cp, kw, clips):
    from retargetvid_tpu_torch.parallel.mesh import make_mesh
    from retargetvid_tpu_torch.parallel.runner import (
        ShardedClipRunner,
        ShardedOneShot,
    )

    mesh = make_mesh(2, device='cpu')
    oneshot = ShardedOneShot(mesh, tn, un, dtype=torch.float32)
    runner = ShardedClipRunner(mesh, un)
    out = {'oneshot': oneshot.run_batch(raws, cp, **kw),
           'runner': runner.run_batch(clips, cp, **CLIP_KW),
           'runner_pairs': (runner.run_batch(clips[:2], cp, **CLIP_KW) +
                            runner.run_batch(clips[2:], cp, **CLIP_KW))}
    for name, call in (('oneshot_3', lambda: oneshot.run_batch(
            raws[:3], cp, **kw)), ('runner_3', lambda: runner.run_batch(
                clips[:3], cp, **CLIP_KW))):
        try:
            call()
        except ValueError as exc:
            out[name] = str(exc)
    return out


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    from retargetvid_tpu_torch.config import sc_init_crop_params
    from retargetvid_tpu_torch.ops.boxes import calc_dest_size

    cp = sc_init_crop_params()
    cp['out_ratio'] = '1:3'
    dest = calc_dest_size(W, H, cp['out_ratio'])
    kw = dict(fps=FPS, w_final=dest['w_final'], h_final=dest['h_final'])
    raws = _raws()
    tn, un = _models()
    ranks = ok_results(run_ranks(
        _rank_batches, 2, tmp_path_factory.mktemp('batches'), tn, un, raws,
        cp, kw, _runner_clips()))
    return dict(cp=cp, kw=kw, raws=raws, ranks=ranks, models=(tn, un))


def test_batch_in_input_order_equals_single_clip_program(runs):
    """Every rank returns the 4 clips in input order; each, run at its live
    count in the batch's 64-frame capacity, equals the single-clip program
    at its own frame count."""
    from retargetvid_tpu_torch.pipeline.oneshot import OneShotClipProgram

    single = OneShotClipProgram(*runs['models'], dtype=torch.float32,
                                device='cpu')
    a, b = (r['oneshot'] for r in runs['ranks'])
    assert len(a) == len(b) == 4
    for raw, got, other in zip(runs['raws'], a, b):
        for key in got:
            np.testing.assert_array_equal(got[key], other[key], err_msg=key)
        want = single.run(raw, runs['cp'], **runs['kw'])
        fc = raw.shape[0]
        assert not got['overrun']
        assert (got['fc_sel'], got['n_segments']) == \
            (want['fc_sel'], want['n_segments'])
        np.testing.assert_allclose(got['probs'][:fc], want['probs'][:fc],
                                   rtol=0, atol=1e-5)
        np.testing.assert_array_equal(got['boxes'], want['boxes'])


def test_clip_runner_two_per_rank_equals_dp_batches(runs):
    for r in runs['ranks']:
        assert len(r['runner']) == len(r['runner_pairs']) == 4
        for got, want in zip(r['runner'], r['runner_pairs']):
            np.testing.assert_array_equal(got['boxes'], want['boxes'])
            np.testing.assert_array_equal(got['mean_sal'], want['mean_sal'])
        # The clips are told apart by their mean saliency (the random
        # weights centre every box alike).
        assert len({float(o['mean_sal']) for o in r['runner']}) == 4


@pytest.mark.parametrize('runner', ('oneshot_3', 'runner_3'))
def test_batch_not_a_multiple_of_dp_raises(runs, runner):
    for r in runs['ranks']:
        assert 'a multiple of dp (2), got 3' in r[runner]
