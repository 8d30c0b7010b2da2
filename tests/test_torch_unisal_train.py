"""Port vs JAX: UNISAL's train-mode forward and its constructor switches.

At ``TINY_UNISAL_CFG`` (B=2, 64x64 frames; every BatchNorm statistic and
the RNN's parameters drawn from a seed): the train-mode forward
(``bn_train=True``, dropout live) static and dynamic, against JAX's
``apply(..., deterministic=False, mutable=['batch_stats'])``, with the
same dropout masks on both sides (``jax.random.bernoulli`` and
``models/dropout.py:keep_mask`` both replaced by one fixed mask per
shape): log-probabilities within 1e-4 and the moved statistics within
1e-5.  Only the active source's statistics move, the backbone's never.
``DomainBN`` alone: flax's per-source momenta (0.99, SALICON 0.9) and the
biased variance.  The ``ds_*`` switches and ``smoothing_rank=None``: the
train-mode forward against JAX, their parameter names through ``convert``
both ways.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_convgru import randomized

torch.set_num_threads(1)

B, H, W = 2, 64, 64
#: The tiny forward's tolerance (``tests/test_torch_unisal_dynamic.py``).
ATOL = 1e-4
STATS_ATOL = 1e-5
SOURCES = ('DHF1K', 'Hollywood', 'UCFSports', 'SALICON')


def fixed_mask(shape, keep):
    """One boolean mask per shape with its singleton axes dropped, so the
    JAX layouts ((B*T, 1, 1, C), (3, 1, 1, 1, C)) and the port's
    ((B*T, C, 1, 1), (3, C)) of one mask draw the same values."""
    key = tuple(int(s) for s in shape if s != 1)
    seed = sum((i + 3) * s for i, s in enumerate(key)) + int(keep * 1000)
    rng = np.random.default_rng(seed)
    return (rng.random(key) < keep).reshape(tuple(int(s) for s in shape))


@pytest.fixture()
def fixed_masks(monkeypatch):
    """Both packages draw their dropout masks from :func:`fixed_mask`."""
    from retargetvid_tpu_torch.models import dropout

    def bernoulli(key, p=0.5, shape=None, mode='low'):
        return jnp.asarray(fixed_mask(shape, float(p)))

    def keep_mask(shape, keep, generator):
        return torch.from_numpy(fixed_mask(shape, keep))

    monkeypatch.setattr(jax.random, 'bernoulli', bernoulli)
    monkeypatch.setattr(dropout, 'keep_mask', keep_mask)


def np_tree(variables):
    return jax.tree_util.tree_map(np.asarray, variables)


def jax_variables(cfg, seed=1):
    """The JAX UNISAL's variables at ``cfg`` (initialised with the RNN),
    every statistic and the RNN's parameters then drawn from ``seed``."""
    from retargetvid_tpu.models.unisal import UNISAL as JUNISAL

    ju = JUNISAL(**cfg)
    variables = np_tree(jax.jit(lambda key, x: ju.init(key, x,
                                                        static=False))(
        jax.random.PRNGKey(seed), jnp.zeros((1, 2, H, W, 3), jnp.float32)))
    variables['batch_stats'] = randomized(variables['batch_stats'], seed)
    for j, name in enumerate(('rnn', 'post_rnn')):
        variables['params'][name] = randomized(variables['params'][name],
                                               seed + 10 + j)
    return variables


def tiny_cfg(**overrides):
    from conftest import TINY_UNISAL_CFG
    return dict(TINY_UNISAL_CFG, **overrides)


@pytest.fixture(scope='module')
def tiny():
    return jax_variables(tiny_cfg())


def batch(t, seed=0):
    return np.random.default_rng(seed).normal(
        0, 1, (B, t, H, W, 3)).astype(np.float32)


def flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def jax_train_forward(cfg, variables, x, source, static):
    from retargetvid_tpu.models.unisal import UNISAL as JUNISAL

    ju = JUNISAL(**dict(cfg, bn_train=True))
    (logp, _), mutated = ju.apply(
        variables, jnp.asarray(x), source=source, static=static,
        deterministic=False, rngs={'dropout': jax.random.PRNGKey(0)},
        mutable=['batch_stats'])
    return np.asarray(logp), np_tree(mutated['batch_stats'])


def port_model(cfg, variables, bn_train=True):
    from retargetvid_tpu_torch.convert import load_flax_variables
    from retargetvid_tpu_torch.models.unisal import UNISAL

    return load_flax_variables(UNISAL(**dict(cfg, bn_train=bn_train)),
                               variables)


def port_train_forward(model, x, source, static):
    from retargetvid_tpu_torch.convert import state_dict_to_flax

    with torch.no_grad():
        logp = model(torch.from_numpy(x), source=source, static=static,
                     deterministic=False,
                     generator=torch.Generator().manual_seed(0))
    return logp.numpy(), state_dict_to_flax(model)['batch_stats']


def compare_stats(old, ref, got, source):
    """Port and JAX moved the same statistics, the same way: returns the
    moved leaves' paths and the largest difference."""
    old, ref, got = (dict(flat(t)) for t in (old, ref, got))
    assert set(ref) == set(got) == set(old)
    moved, err = [], 0.0
    for path in old:
        err = max(err, float(np.abs(got[path] - ref[path]).max()))
        if not np.array_equal(ref[path], old[path]):
            moved.append(path)
            assert not np.array_equal(got[path], old[path]), path
        else:
            assert np.array_equal(got[path], old[path]), path
    for path in moved:
        assert path[0] != 'cnn', path
        bn = [p for p in path if p.startswith('bn_')]
        assert not bn or bn[-1] == f'bn_{source.lower()}', path
    return moved, err


@pytest.mark.parametrize('static', [True, False], ids=['static', 'dynamic'])
def test_train_forward_matches_jax(tiny, fixed_masks, static):
    source = 'SALICON' if static else 'DHF1K'
    x = batch(1 if static else 3, seed=int(static))
    ref, ref_stats = jax_train_forward(tiny_cfg(), tiny, x, source, static)
    model = port_model(tiny_cfg(), tiny)
    out, stats = port_train_forward(model, x, source, static)
    err = float(np.abs(out - ref).max())
    moved, stats_err = compare_stats(tiny['batch_stats'], ref_stats, stats,
                                     source)
    print(f'train forward ({source}, static={static}): logp {err:.3g}, '
          f'{len(moved)} statistics moved, max |diff| {stats_err:.3g}')
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)
    assert stats_err <= STATS_ATOL
    # The dynamic step runs the ConvGRU, whose statistics move; a static
    # batch bypasses it.
    assert any(p[0] == 'rnn' for p in moved) == (not static)
    assert ('post_cnn', 'dw_bn', 'mean') in moved
    # Dropout was live: the deterministic forward differs.
    with torch.no_grad(), model.bn_mode(False):
        det = model(torch.from_numpy(x), source=source, static=static)
    assert np.abs(det.numpy() - out).max() > 1e-3


def test_domain_bn_momenta_and_biased_variance():
    """Each source's BatchNorm against flax's: SALICON moves at momentum
    0.9, the dynamic sources at 0.99; the stored variance is the biased
    one; only the active source's statistics move."""
    from retargetvid_tpu.models.layers import DomainBN as JDomainBN
    from retargetvid_tpu_torch.convert import load_flax_variables
    from retargetvid_tpu_torch.models.layers import DomainBN, set_bn_train

    rng = np.random.default_rng(3)
    x = rng.normal(1.5, 2.0, (4, 5, 6, 8)).astype(np.float32)     # NHWC
    jbn = JDomainBN(sources=SOURCES, use_running_average=False)
    variables = randomized(np_tree(jbn.init(jax.random.PRNGKey(0), x)), 4)
    for source in SOURCES:
        ref, mutated = jbn.apply(variables, jnp.asarray(x), source,
                                 mutable=['batch_stats'])
        bn = load_flax_variables(DomainBN(8, SOURCES), variables)
        set_bn_train(bn, True)
        with torch.no_grad():
            out = bn(torch.from_numpy(x).permute(0, 3, 1, 2), source)
        np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(ref), rtol=0, atol=1e-5)
        m = 0.9 if source == 'SALICON' else 0.99
        for src in SOURCES:
            child = getattr(bn, f'bn_{src.lower()}')
            old = variables['batch_stats'][f'bn_{src.lower()}']
            new = mutated['batch_stats'][f'bn_{src.lower()}']
            for stat, buf in (('mean', child.running_mean),
                              ('var', child.running_var)):
                np.testing.assert_allclose(buf.numpy(), new[stat], rtol=0,
                                           atol=1e-6)
                if src != source:
                    assert np.array_equal(buf.numpy(), old[stat])
            if src == source:
                batch_var = x.reshape(-1, 8).var(axis=0)          # biased
                np.testing.assert_allclose(
                    child.running_var.numpy(),
                    m * old['var'] + (1 - m) * batch_var, rtol=1e-5)
                np.testing.assert_allclose(
                    child.running_mean.numpy(),
                    m * old['mean'] + (1 - m) * x.reshape(-1, 8).mean(0),
                    rtol=0, atol=1e-5)


SWITCHES = {
    'ds_bn_off': dict(ds_bn=False),
    'ds_adaptation_smoothing_gaussians_off': dict(
        ds_adaptation=False, ds_smoothing=False, ds_gaussians=False),
    'full_smoothing_kernel': dict(smoothing_rank=None),
    'all_off_full_kernel': dict(ds_bn=False, ds_adaptation=False,
                                ds_smoothing=False, ds_gaussians=False,
                                smoothing_rank=None),
}


@pytest.mark.parametrize('name', list(SWITCHES))
def test_switches_match_jax(name, fixed_masks):
    """Each switch: the parameter names carry across both ways exactly and
    the train-mode dynamic forward matches JAX, statistics included."""
    from retargetvid_tpu_torch.convert import state_dict_to_flax

    cfg = tiny_cfg(**SWITCHES[name])
    variables = jax_variables(cfg, seed=2)
    model = port_model(cfg, variables)
    back = state_dict_to_flax(model)
    for col in ('params', 'batch_stats'):
        ref, got = dict(flat(variables[col])), dict(flat(back[col]))
        assert set(ref) == set(got), (col, sorted(set(ref) ^ set(got))[:6])
        for path in ref:
            assert np.array_equal(ref[path], got[path]), path
    names = {path[0] for path, _ in flat(variables['params'])}
    suffix = {k: '' if not SWITCHES[name].get(k, True) else '_dhf1k'
              for k in ('ds_adaptation', 'ds_smoothing', 'ds_gaussians')}
    assert f'adaptation{suffix["ds_adaptation"]}' in names
    assert f'coarse_gaussians{suffix["ds_gaussians"]}' in names
    full = SWITCHES[name].get('smoothing_rank', 4) is None
    assert (f'smoothing{suffix["ds_smoothing"]}' in names) == full
    assert (f'smoothing_v{suffix["ds_smoothing"]}' in names) == (not full)
    shared_bn = 'bn_dhf1k' not in variables['params']['skip_2x']['reduction_bn']
    assert shared_bn == (not SWITCHES[name].get('ds_bn', True))

    x = batch(2, seed=5)
    ref, ref_stats = jax_train_forward(cfg, variables, x, 'UCFSports',
                                       False)
    out, stats = port_train_forward(model, x, 'UCFSports', False)
    _, stats_err = compare_stats(variables['batch_stats'], ref_stats, stats,
                                 'UCFSports')
    print(f'{name}: train logp {np.abs(out - ref).max():.3g}, stats '
          f'{stats_err:.3g}')
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)
    assert stats_err <= STATS_ATOL


def test_seeded_weights_unchanged_by_the_switches():
    """``seeded_init_`` draws the same weights for the default model as
    before the training knobs: the knobs add no module before ``rnn``, and
    an inert switch (``drop_probs``, ``bn_train``) changes no weight."""
    from retargetvid_tpu_torch.models.init import seeded_init_
    from retargetvid_tpu_torch.models.unisal import UNISAL

    base = seeded_init_(UNISAL(**tiny_cfg()), 5).state_dict()
    knobs = seeded_init_(UNISAL(**tiny_cfg(drop_probs=(0.1, 0.2, 0.3),
                                           bn_train=True)), 5).state_dict()
    assert set(base) == set(knobs)
    for k in base:
        assert torch.equal(base[k], knobs[k]), k


def test_relu6_gradient_splits_at_ties_as_jax():
    """JAX's ``min(max(x, 0), 6)`` passes half the gradient at x == 0 and
    x == 6; the port's ``relu6`` does too where a gradient is taken (the
    ConvGRU's zero first hidden state meets the tie at 0 exactly)."""
    from retargetvid_tpu.models.layers import relu6 as jrelu6
    from retargetvid_tpu_torch.models.layers import relu6

    v = np.array([0.0, 6.0, 3.0, -1.0, 7.0, -0.0], np.float32)
    ref = np.asarray(jax.grad(lambda a: jnp.sum(jrelu6(a) * 3.0))(v))
    x = torch.from_numpy(v).requires_grad_(True)
    (relu6(x) * 3.0).sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), ref)
    assert ref[0] == ref[1] == 1.5
    with torch.no_grad():
        np.testing.assert_array_equal(relu6(torch.from_numpy(v)).numpy(),
                                      np.asarray(jrelu6(v)))
