"""Port vs JAX: the hand-rolled SGD, the gradient masks and the train and
eval steps.

- ``make_optimizer`` on a seeded tree over three updates: the global-norm
  clip (the first gradients are clipped, the later ones not), weight
  decay and momentum only where the mask is 1 (an unused parameter, whose
  port gradient is None, still decays), the frozen trace where it is 0,
  the staircase learning rate (``steps_per_epoch=2``); 1e-6 relative
  (1e-7 absolute).
- ``_grad_mask`` leaf by leaf on the tiny UNISAL tree, the port's dotted
  names carried to JAX's paths by ``convert.flax_name``.
- Two train steps per (static/dynamic, ``train_cnn`` on/off) at
  ``TINY_UNISAL_CFG`` (B=2, 64x64, ``bn_train=True``, dropout live with
  the same fixed masks on both sides), against ``make_train_step``: the
  loss and each summand, the parameters, the moved statistics and the
  momentum trace after each step, taken from JAX's state before it (the
  second with a live trace at the decayed rate), within 1e-5 absolute +
  1e-4 relative; a frozen backbone does not move.
- Three chained train steps at the default lr with every dropout mask
  all ones: losses within 1e-5 relative.
- The eval step against ``make_eval_step``: 1e-5 absolute.

The variables come from the port's seeded UNISAL (statistics drawn from a
seed) through ``convert.state_dict_to_flax``; the JAX side adopts them.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_convgru import randomized
from test_torch_unisal_train import fixed_masks  # noqa: F401 (fixture)
from test_torch_unisal_train import flat, np_tree, tiny_cfg

torch.set_num_threads(1)

ATOL, RTOL = 1e-5, 1e-4
B, H, W = 2, 64, 64


@pytest.fixture(scope='module')
def tree():
    """The port's seeded tiny UNISAL as JAX trees, statistics random."""
    from retargetvid_tpu_torch.convert import state_dict_to_flax
    from retargetvid_tpu_torch.models.init import seeded_init_
    from retargetvid_tpu_torch.models.unisal import UNISAL

    variables = state_dict_to_flax(seeded_init_(UNISAL(**tiny_cfg()), 3))
    variables['batch_stats'] = np_tree(randomized(variables['batch_stats'],
                                                  3))
    return variables


def batch(t, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (B, t, H, W, 3)).astype(np.float32)
    sal = rng.random((B, t, H, W, 1)).astype(np.float32) ** 2
    sal /= sal.sum(axis=(2, 3, 4), keepdims=True)
    fix = (rng.random((B, t, H, W, 1)) > 0.98).astype(np.float32)
    return x, sal, fix


def assert_trees_close(got, ref, label, atol=ATOL, rtol=RTOL):
    ref, got = dict(flat(ref)), dict(flat(got))
    assert set(ref) == set(got), label
    err = 0.0
    for path in ref:
        err = max(err, float(np.abs(got[path] - ref[path]).max()))
        np.testing.assert_allclose(got[path], ref[path], rtol=rtol,
                                   atol=atol, err_msg=f'{label} {path}')
    return err


# -- the optimizer -----------------------------------------------------------

OPT_TREE = {'cnn': {'kernel': (3, 4)}, 'skip_dhf1k': {'kernel': (5,)},
            'adaptation_salicon': {'bias': (2,)}, 'post': {'w': (4, 4)},
            'unused': {'bias': (3,)}}
#: 0 freezes the leaf (no decay, no momentum, no movement).
OPT_MASK = {'adaptation_salicon': 0.0}


def test_make_optimizer_matches_jax():
    import optax

    from retargetvid_tpu.train.trainer import make_optimizer as jmake
    from retargetvid_tpu_torch.train.trainer import make_optimizer

    rng = np.random.default_rng(0)
    params = {k: {n: rng.normal(0, 1, s).astype(np.float32)
                  for n, s in v.items()} for k, v in OPT_TREE.items()}
    mask = {k: {n: np.float32(OPT_MASK.get(k, 1.0)) for n in v}
            for k, v in OPT_TREE.items()}
    names = {'.'.join(p): p for p, _ in flat(params)}
    jtx = jmake(params, steps_per_epoch=2)
    jstate = jtx.init(params)
    jparams = params
    tx = make_optimizer(steps_per_epoch=2)
    tparams = {n: torch.from_numpy(dict(flat(params))[p].copy())
               for n, p in names.items()}
    tstate = tx.init(tparams)
    tmask = {n: float(dict(flat(mask))[p]) for n, p in names.items()}
    for i, scale in enumerate((50.0, 0.1, 0.1)):     # clipped, then not
        grads = {k: {n: (scale * rng.normal(0, 1, s)).astype(np.float32)
                     for n, s in v.items()} for k, v in OPT_TREE.items()}
        grads['unused']['bias'][:] = 0.0
        masked = jax.tree_util.tree_map(lambda g, m: g * m, grads, mask)
        upd, jstate = jtx.update(masked, jstate, (jparams, mask))
        jparams = np_tree(optax.apply_updates(jparams, upd))
        tgrads = {n: (None if n == 'unused.bias'
                      else torch.from_numpy(dict(flat(grads))[p].copy()))
                  for n, p in names.items()}
        tstate = tx.update(tparams, tgrads, tmask, tstate)
        assert tstate['count'] == int(jstate['count']) == i + 1
        for n, p in names.items():
            ref = dict(flat(jparams))[p]
            np.testing.assert_allclose(tparams[n].numpy(), ref, rtol=1e-6,
                                       atol=1e-7, err_msg=n)
            np.testing.assert_allclose(
                tstate['trace'][n].numpy(),
                dict(flat(np_tree(jstate['trace'])))[p], rtol=1e-6,
                atol=1e-7, err_msg=n)
    # Frozen: never moved, trace zero; unused: decayed with momentum.
    np.testing.assert_array_equal(tparams['adaptation_salicon.bias'].numpy(),
                                  params['adaptation_salicon']['bias'])
    assert not tstate['trace']['adaptation_salicon.bias'].any()
    assert not np.array_equal(tparams['unused.bias'].numpy(),
                              params['unused']['bias'])
    assert tx.lr_at(1) == np.float32(0.04)
    np.testing.assert_allclose(tx.lr_at(2), 0.04 * 0.8, rtol=1e-7)


# -- the gradient masks ------------------------------------------------------

@pytest.mark.parametrize('source,static,train_cnn,sources', [
    ('DHF1K', False, True, None),
    ('SALICON', True, False, None),
    ('UCFSports', False, False, None),
    ('Hollywood', True, True, ('DHF1K', 'Hollywood')),
    ('SALICON', True, True, ('MIT1003',)),
])
def test_grad_mask_leaf_by_leaf(tree, source, static, train_cnn, sources):
    from retargetvid_tpu.train.trainer import _grad_mask as jmask
    from retargetvid_tpu_torch.convert import flax_name
    from retargetvid_tpu_torch.models.unisal import UNISAL
    from retargetvid_tpu_torch.train.trainer import _grad_mask

    sources = sources or ('DHF1K', 'Hollywood', 'UCFSports', 'SALICON')
    ref = dict(flat(np_tree(jmask(tree['params'], source=source,
                                  static_batch=static, train_cnn=train_cnn,
                                  sources=sources))))
    names = [n for n, _ in UNISAL(**tiny_cfg()).named_parameters()]
    got = _grad_mask(names, source=source, static_batch=static,
                     train_cnn=train_cnn, sources=sources)
    assert sorted(flax_name(p) for p in ref) == sorted(got)
    for path, m in ref.items():
        assert got[flax_name(path)] == float(m), path
    assert 0.0 < np.mean(list(got.values())) < 1.0


# -- the train and eval steps ------------------------------------------------

def jax_steps(tree, source, train_cnn, batches):
    """JAX's state (params, batch_stats, trace) and outputs after each of
    the steps over ``batches``."""
    from retargetvid_tpu.models.unisal import UNISAL as JUNISAL
    from retargetvid_tpu.train.trainer import TrainState as JState
    from retargetvid_tpu.train.trainer import make_optimizer as jmake
    from retargetvid_tpu.train.trainer import make_train_step as jstep

    jm = JUNISAL(**tiny_cfg(bn_train=True))
    tx = jmake(tree['params'], steps_per_epoch=1)
    state = JState(params=tree['params'], batch_stats=tree['batch_stats'],
                   opt_state=tx.init(tree['params']), step=0)
    step = jstep(jm, tx, source=source, train_cnn=train_cnn, donate=False)
    states = []
    for i, (x, sal, fix) in enumerate(batches):
        state, out = step(state, x, sal, fix, jax.random.PRNGKey(i))
        states.append((np_tree(state.params), np_tree(state.batch_stats),
                       np_tree(state.opt_state['trace']),
                       {k: float(v) for k, v in out.items()}))
    return states


def port_step(start, count, source, train_cnn, batch):
    """One port step from ``start`` = (params, batch_stats, trace) JAX
    trees at optimizer count ``count``; the same tuple after it."""
    from retargetvid_tpu_torch.convert import (
        flax_param_tree,
        flax_to_state_dict,
        load_flax_variables,
        state_dict_to_flax,
    )
    from retargetvid_tpu_torch.models.unisal import UNISAL
    from retargetvid_tpu_torch.train.trainer import (
        TrainState,
        make_optimizer,
        make_train_step,
    )

    model = load_flax_variables(UNISAL(**tiny_cfg(bn_train=True)),
                                {'params': start[0], 'batch_stats': start[1]})
    tx = make_optimizer(steps_per_epoch=1)
    trace = flax_to_state_dict({'params': start[2]})
    state = TrainState({'trace': trace, 'count': count}, count)
    step = make_train_step(model, tx, source=source, train_cnn=train_cnn,
                           generator=torch.Generator().manual_seed(0))
    state, out = step(state, *map(torch.from_numpy, batch))
    assert state.step == count + 1 == state.opt_state['count']
    back = state_dict_to_flax(model)
    return (back['params'], back['batch_stats'],
            flax_param_tree(model, state.opt_state['trace']),
            {k: float(v) for k, v in out.items()})


@pytest.mark.parametrize('static', [True, False], ids=['static', 'dynamic'])
@pytest.mark.parametrize('train_cnn', [True, False],
                         ids=['train_cnn', 'frozen_cnn'])
def test_train_step_matches_jax(tree, fixed_masks, static, train_cnn):
    """Each step from the state JAX had before it: the first from the
    seeded tree (zero trace, lr 0.04), the second from JAX's state after
    the first (a live trace, the decayed lr 0.032).  Chained, the second
    step would start from the port's own first step, a few ulp from JAX's,
    and single entries of its trace then move by more than the
    tolerance."""
    source = 'SALICON' if static else 'DHF1K'
    batches = [batch(1 if static else 2, seed=10 * i + int(static))
               for i in range(2)]
    zero = jax.tree_util.tree_map(np.zeros_like, tree['params'])
    ref = jax_steps(tree, source, train_cnn, batches)
    starts = [(tree['params'], tree['batch_stats'], zero)] + \
        [r[:3] for r in ref[:-1]]
    for count, (start, r, b) in enumerate(zip(starts, ref, batches)):
        got = port_step(start, count, source, train_cnn, b)
        assert set(r[3]) == set(got[3]) == {'loss', 'kld', 'nss', 'cc'}
        for k in r[3]:
            np.testing.assert_allclose(got[3][k], r[3][k], rtol=RTOL,
                                       atol=ATOL, err_msg=k)
        errs = [assert_trees_close(g, rr, f'step {count + 1} {label}')
                for g, rr, label in zip(got[:3], r[:3],
                                        ('params', 'batch_stats', 'trace'))]
        print(f'train step {count + 1} {source} train_cnn={train_cnn}: '
              f'loss {got[3]["loss"]:.6g} (JAX {r[3]["loss"]:.6g}), max '
              f'|diff| params {errs[0]:.3g}, stats {errs[1]:.3g}, trace '
              f'{errs[2]:.3g}')
        old = dict(flat(start[0]))
        cnn_moved = any(not np.array_equal(v, old[p])
                        for p, v in flat(got[0]) if p[0] == 'cnn')
        assert cnn_moved == train_cnn
        rnn_moved = any(not np.array_equal(v, old[p])
                        for p, v in flat(got[0]) if p[0] == 'rnn')
        assert rnn_moved == (not static)


def test_eval_step_matches_jax(tree):
    from retargetvid_tpu.models.unisal import UNISAL as JUNISAL
    from retargetvid_tpu.train.trainer import make_eval_step as jeval
    from retargetvid_tpu_torch.convert import (
        load_flax_variables,
        state_dict_to_flax,
    )
    from retargetvid_tpu_torch.models.unisal import UNISAL
    from retargetvid_tpu_torch.train.trainer import make_eval_step

    x, sal, fix = batch(2, seed=7)
    ref = jeval(JUNISAL(**tiny_cfg()), source='Hollywood')(
        tree['params'], tree['batch_stats'], x, sal, fix)
    model = load_flax_variables(UNISAL(**tiny_cfg(bn_train=True)), tree)
    out = make_eval_step(model, source='Hollywood')(
        *map(torch.from_numpy, (x, sal, fix)))
    assert set(out) == set(ref)
    for k in ref:
        np.testing.assert_allclose(float(out[k]), float(ref[k]), rtol=0,
                                   atol=ATOL, err_msg=k)
    # bn_train is restored and no statistic moved.
    assert model.bn_train
    assert_trees_close(state_dict_to_flax(model)['batch_stats'],
                       tree['batch_stats'], 'batch_stats', atol=0, rtol=0)


def test_chained_steps_with_unit_masks_match_jax(tree, monkeypatch):
    """Three chained DHF1K steps at the default lr from the seeded narrow
    model (statistics drawn from a seed), every dropout mask all ones on
    both sides: the losses within 1e-5 relative.  (From the seeded
    zero-mean statistics instead, whole channels of the decoder's
    train-mode BatchNorm have zero variance; their reduction-order rounding,
    times 1/sqrt(eps), decides ReLU6 gates, and single gradient leaves
    part from JAX's.)"""
    from retargetvid_tpu.train.trainer import Trainer as JTrainer
    from retargetvid_tpu_torch.models import dropout
    from retargetvid_tpu_torch.train.trainer import Trainer

    monkeypatch.setattr(jax.random, 'bernoulli', lambda key, p=0.5,
                        shape=None, mode='low': jnp.ones(shape, bool))
    monkeypatch.setattr(dropout, 'keep_mask', lambda shape, keep, gen:
                        torch.ones(tuple(shape), dtype=torch.bool))
    x, sal, fix = batch(3, seed=4)
    pt = Trainer(model_cfg=tiny_cfg(), device='cpu', steps_per_epoch=2)
    pt.init_state(variables=tree)
    jt = JTrainer(model_cfg=tiny_cfg(), steps_per_epoch=2)
    jt.init_state(variables=tree)
    jstep = jt.step_fn('DHF1K', False, True)
    pstep = pt.step_fn('DHF1K', False, True)
    losses = []
    for i in range(3):
        jt.state, ref = jstep(jt.state, x, sal, fix, jax.random.PRNGKey(i))
        pt.state, out = pstep(pt.state, *(pt._batch(a)
                                          for a in (x, sal, fix)))
        losses.append((float(out['loss']), float(ref['loss'])))
    print(f'chained steps, unit masks: (port, JAX) losses {losses}')
    for got, ref in losses:
        np.testing.assert_allclose(got, ref, rtol=1e-5)
