"""Multi-ratio serving: the port's ``dispatch_multi``/``collect_multi`` vs
the JAX package's, and vs the port's own per-ratio ``run``.

The clip, models and weights are those of ``test_torch_oneshot.py``
(fc=48 at 72x128, ``TINY_UNISAL_CFG``, float32) with a narrow TransNet
(``f=2, d=16``, head biased); the destinations are the benchmark's 1:3
and 3:1.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_oneshot import FC, H, W, clip_frames, models

torch.set_num_threads(1)

RATIOS = ('1:3', '3:1')


@pytest.fixture(scope='module')
def runs():
    from retargetvid_tpu.config import sc_init_crop_params
    from retargetvid_tpu.pipeline.oneshot import OneShotClipProgram as JProg
    from retargetvid_tpu_torch.ops.boxes import calc_dest_size
    from retargetvid_tpu_torch.pipeline.oneshot import OneShotClipProgram

    cp = sc_init_crop_params()
    frames = clip_frames()
    dests = [(d['w_final'], d['h_final'])
             for d in (calc_dest_size(W, H, r) for r in RATIOS)]
    jt, tn_params, ju, un_vars, tn, un = models(f=2, d=16)
    j_prog = JProg(jt, tn_params, variables=un_vars, model=ju,
                   dtype=jnp.float32)
    j_ticket = j_prog.dispatch_multi(jnp.asarray(frames), cp, fps=30.0,
                                     dests=dests)
    program = OneShotClipProgram(tn, un, dtype=torch.float32, device='cpu')
    ticket = program.dispatch_multi(frames, cp, fps=30.0, dests=dests)
    singles = [program.run(frames, cp, fps=30.0, w_final=wf, h_final=hf)
               for wf, hf in dests]
    return (j_prog.collect_multi(j_ticket), program.collect_multi(ticket),
            singles, j_ticket[1], ticket[1], dests)


def test_packed_layout_matches_jax(runs):
    """Same keys, offsets and shapes in the packed vector, with the leading
    ratio axis on the ratio-dependent keys."""
    *_, j_spec, spec, dests = runs
    assert spec == j_spec
    assert spec['boxes'][1] == (len(dests), FC, 4)
    assert spec['mean_sal'][1] == ()


@pytest.mark.parametrize('r', range(len(RATIOS)))
def test_multi_ratio_vs_jax(runs, r):
    """Per ratio: picks and shots equal, probs within 1e-5, boxes within
    1 px (the JAX package vmaps the box tail)."""
    refs, outs, _, _, _, dests = runs
    ref, out = refs[r], outs[r]
    assert out['fc_sel'] == ref['fc_sel'] > 0
    assert out['n_segments'] == ref['n_segments']
    np.testing.assert_allclose(out['probs'], ref['probs'], rtol=0,
                               atol=1e-5)
    box_err = int(np.abs(out['boxes'] - ref['boxes']).max())
    print(f'{RATIOS[r]}: boxes max |diff| {box_err} px (tolerance 1 px)')
    assert out['boxes'].shape == ref['boxes'].shape == (FC, 4)
    assert box_err <= 1
    wf, hf = dests[r]
    assert (out['boxes'][:, 2] - out['boxes'][:, 0] == wf).all()
    assert (out['boxes'][:, 3] - out['boxes'][:, 1] == hf).all()


@pytest.mark.parametrize('r', range(len(RATIOS)))
def test_multi_ratio_equals_per_ratio_run(runs, r):
    """Every output of ratio r equals the port's ``run`` for that ratio."""
    _, outs, singles, _, _, _ = runs
    out, single = outs[r], singles[r]
    assert out.keys() == single.keys()
    for k in out:
        assert np.array_equal(np.asarray(out[k]), np.asarray(single[k])), k
