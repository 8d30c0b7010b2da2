"""Port vs JAX: UNISAL's dynamic (ConvGRU) path.

At ``TINY_UNISAL_CFG`` (the JAX tree initialised with ``static=False`` so
it holds the RNN, whose parameters and statistics are then drawn from a
seed): the dynamic forward and its final hidden state (NHWC in JAX, NCHW
in the port), a chunked run carrying ``h0`` against one pass, and the
knobs ``bypass_rnn``, ``res_rnn``, ``with_rnn`` and the ``static=None``
rule.  At full width: one dynamic forward from the seeded reference state
dict of ``tests/fixtures/unisal_sd_shapes.json`` through both packages'
checkpoint loaders, which covers every ``rnn``/``post_rnn`` key.  Also: the
ConvGRU, registered last, leaves the seeded weights of every other module
as they were without it.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_convgru import randomized

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
B, T, H, W = 1, 4, 64, 96
TARGET = (40, 60)
#: The static forward's tolerances (``tests/test_torch_models.py``).
ATOL = 1e-4
RTOL_FULL = 1e-3


def _np_tree(variables):
    return jax.tree_util.tree_map(np.asarray, variables)


@pytest.fixture(scope='module')
def tiny():
    return tiny_variables()


def tiny_variables():
    """The JAX UNISAL's variables at ``TINY_UNISAL_CFG``, initialised with
    the RNN, whose subtrees are then drawn from a seed."""
    from conftest import TINY_UNISAL_CFG
    from retargetvid_tpu.models.unisal import UNISAL as JUNISAL

    ju = JUNISAL(**TINY_UNISAL_CFG)
    variables = _np_tree(jax.jit(lambda key, x: ju.init(key, x,
                                                        static=False))(
        jax.random.PRNGKey(1), jnp.zeros((1, 2, 64, 64, 3), jnp.float32)))
    for i, col in enumerate(('params', 'batch_stats')):
        for j, name in enumerate(('rnn', 'post_rnn')):
            variables[col][name] = randomized(variables[col][name],
                                              10 * i + j)
    return variables


def tiny_models(variables, **overrides):
    """(JAX UNISAL, its variables, the port's UNISAL holding them) at
    ``TINY_UNISAL_CFG`` with ``overrides``; without the RNN both trees
    leave out ``rnn``/``post_rnn``."""
    from conftest import TINY_UNISAL_CFG
    from retargetvid_tpu.models.unisal import UNISAL as JUNISAL
    from retargetvid_tpu_torch.convert import load_flax_variables
    from retargetvid_tpu_torch.models.unisal import UNISAL

    cfg = dict(TINY_UNISAL_CFG, **overrides)
    if not cfg.get('with_rnn', True):
        variables = {col: {k: v for k, v in tree.items()
                           if k not in ('rnn', 'post_rnn')}
                     for col, tree in variables.items()}
    return (JUNISAL(**cfg), variables,
            load_flax_variables(UNISAL(**cfg), variables))


def frames(t=T, seed=0):
    return np.random.default_rng(seed).normal(
        0, 1, (B, t, H, W, 3)).astype(np.float32)


def jax_forward(ju, variables, x, h0=None, static=False, source='DHF1K'):
    fn = jax.jit(lambda v, x, h0: ju.apply(v, x, target_size=TARGET,
                                           source=source, static=static,
                                           h0=h0))
    out, hidden = fn(variables, jnp.asarray(x),
                     None if h0 is None else jnp.asarray(h0))
    return np.asarray(out), None if hidden is None else np.asarray(hidden)


def port_forward(model, x, h0=None, static=False, source='DHF1K'):
    with torch.no_grad():
        out, hidden = model.forward_with_hidden(
            torch.from_numpy(x), target_size=TARGET, source=source,
            static=static, h0=h0)
    return out.numpy(), hidden


def nhwc(h):
    return h.permute(0, 2, 3, 1).numpy()


def test_dynamic_forward_and_hidden(tiny):
    ju, variables, model = tiny_models(tiny)
    x = frames()
    ref, ref_h = jax_forward(ju, variables, x)
    out, hidden = port_forward(model, x)
    assert out.shape == ref.shape == (B, T, *TARGET, 1)
    assert hidden.shape == (B, 32, 2, 3)
    err = float(np.abs(out - ref).max())
    err_h = float(np.abs(nhwc(hidden) - ref_h).max())
    print(f'dynamic tiny: logp max |diff| {err:.3g}, hidden {err_h:.3g} '
          f'(atol {ATOL})')
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)
    np.testing.assert_allclose(nhwc(hidden), ref_h, rtol=0, atol=ATOL)


def test_chunked_with_carried_h0_equals_one_pass(tiny):
    """Two chunks of 2 frames, the hidden state carried from the first
    into the second, give the one 4-frame pass of JAX."""
    ju, variables, model = tiny_models(tiny)
    x = frames(seed=1)
    ref, ref_h = jax_forward(ju, variables, x)
    first, h1 = port_forward(model, x[:, :2])
    second, h2 = port_forward(model, x[:, 2:], h0=h1)
    out = np.concatenate([first, second], axis=1)
    err = float(np.abs(out - ref).max())
    print(f'chunked with carried h0 vs one JAX pass: max |diff| {err:.3g}')
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)
    np.testing.assert_allclose(nhwc(h2), ref_h, rtol=0, atol=ATOL)
    # The carry matters: a second chunk started from zeros differs.
    fresh, _ = port_forward(model, x[:, 2:])
    assert np.abs(fresh - second).max() > 10 * ATOL


#: (label, UNISAL overrides, ``static``, frames, whether the RNN runs).
KNOBS = [
    ('bypass_rnn=False, static', dict(bypass_rnn=False), True, 2, True),
    ('res_rnn=False', dict(res_rnn=False), False, 2, True),
    ('with_rnn=False', dict(with_rnn=False), False, 2, False),
    ('static=None, T=1', {}, None, 1, False),
    ('static=None, T=2', {}, None, 2, True),
]


@pytest.mark.parametrize('label,overrides,static,t,rnn_runs', KNOBS,
                         ids=[k[0] for k in KNOBS])
def test_knobs(tiny, label, overrides, static, t, rnn_runs):
    ju, variables, model = tiny_models(tiny, **overrides)
    x = frames(t=t, seed=2)
    ref, ref_h = jax_forward(ju, variables, x, static=static)
    out, hidden = port_forward(model, x, static=static)
    assert (hidden is not None) == (ref_h is not None) == rnn_runs
    err = float(np.abs(out - ref).max())
    print(f'{label}: max |diff| {err:.3g} (atol {ATOL})')
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)
    if rnn_runs:
        np.testing.assert_allclose(nhwc(hidden), ref_h, rtol=0, atol=ATOL)
    assert hasattr(model, 'rnn') == overrides.get('with_rnn', True)


def test_salicon_only_model_is_static_by_default():
    """``static=None`` on a SALICON-only model is the static forward even
    for T > 1 (the rule of ``retargetvid_tpu/models/unisal.py:196-197``)."""
    from conftest import TINY_UNISAL_CFG
    from retargetvid_tpu_torch.models.init import seeded_init_
    from retargetvid_tpu_torch.models.unisal import UNISAL

    model = seeded_init_(UNISAL(sources=('SALICON',), **TINY_UNISAL_CFG), 4)
    x = frames(t=2, seed=5)
    out, hidden = port_forward(model.eval(), x, static=None,
                               source='SALICON')
    static, _ = port_forward(model, x, static=True, source='SALICON')
    dynamic, dyn_h = port_forward(model, x, static=False, source='SALICON')
    assert hidden is None and dyn_h is not None
    np.testing.assert_array_equal(out, static)
    assert np.abs(dynamic - static).max() > 10 * ATOL


@pytest.mark.parametrize('cfg', ['full', 'tiny'])
def test_rnn_registered_last_keeps_seeded_weights(cfg):
    """``seeded_init_`` gives every module that existed without the
    ConvGRU the same weights as a model built without it."""
    from conftest import TINY_UNISAL_CFG
    from retargetvid_tpu_torch.models.init import seeded_init_
    from retargetvid_tpu_torch.models.unisal import UNISAL

    kw = TINY_UNISAL_CFG if cfg == 'tiny' else {}
    with_rnn = seeded_init_(UNISAL(**kw), 1).state_dict()
    static = seeded_init_(UNISAL(with_rnn=False, **kw), 1).state_dict()
    assert set(with_rnn) - set(static) == {
        k for k in with_rnn if k.startswith(('rnn.', 'post_rnn.'))}
    for k, v in static.items():
        assert torch.equal(with_rnn[k], v), k
    assert list(with_rnn)[-1].startswith('post_rnn.')


def test_full_width_dynamic_from_checkpoint():
    """Full width at 1x3x64x96 from the seeded reference state dict: the
    port through ``load_unisal_state_dict``, JAX on the tree of its
    converter.  The log-probabilities are held end to end; the ConvGRU's
    outputs and hidden state on the same ``post_cnn`` features at 1e-5.
    End to end, the synthesized weights saturate the gates, which magnify
    the static backbone's float32 differences (the log-probabilities'
    0.0019 at this shape) into 1.6e-3 of hidden state: the bound there is
    2e-3."""
    from retargetvid_tpu.models.convgru import ConvGRU as JGRU
    from retargetvid_tpu.models.torch_import import convert_unisal_state_dict
    from retargetvid_tpu.models.unisal import UNISAL as JUNISAL
    from retargetvid_tpu_torch.models.torch_import import (
        load_unisal_state_dict,
    )
    from retargetvid_tpu_torch.models.unisal import UNISAL

    spec = importlib.util.spec_from_file_location(
        'make_conversion_fixtures',
        ROOT / 'tools' / 'make_conversion_fixtures.py')
    fixgen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fixgen)
    with open(ROOT / 'tests' / 'fixtures' / 'unisal_sd_shapes.json') as fp:
        shapes = json.load(fp)
    sd = {k: fixgen.synth_value(k, sh, dt) for k, (sh, dt) in shapes.items()}
    assert any(k.startswith('rnn.') for k in sd)
    params, stats, _ = convert_unisal_state_dict(sd, smoothing_rank=8)
    model = load_unisal_state_dict(UNISAL(), sd).eval()
    x = frames(t=3, seed=3)
    ref, ref_h = jax_forward(JUNISAL(), {'params': params,
                                         'batch_stats': stats}, x)
    feats = {}
    hook = model.post_cnn.register_forward_hook(
        lambda mod, args, out: feats.setdefault('post_cnn', out))
    out, hidden = port_forward(model, x)
    hook.remove()
    err = float(np.abs(out - ref).max())
    err_h = float(np.abs(nhwc(hidden) - ref_h).max())
    assert hidden.shape == (1, 256, 2, 3)
    np.testing.assert_allclose(out, ref, rtol=RTOL_FULL, atol=ATOL)
    np.testing.assert_allclose(nhwc(hidden), ref_h, rtol=0, atol=2e-3)

    seq = feats['post_cnn'][None]                   # (1, 3, 256, 2, 3)
    j_outs, j_h = JGRU(256, 256).apply(
        {'params': params['rnn'], 'batch_stats': stats['rnn']},
        jnp.asarray(np.moveaxis(seq.numpy(), 2, -1)))
    with torch.no_grad():
        outs, h_rnn = model.rnn(seq)
    err_rnn = float(np.abs(nhwc(h_rnn) - np.asarray(j_h)).max())
    print(f'full-width dynamic: logp max |diff| {err:.3g} (rtol '
          f'{RTOL_FULL}, atol {ATOL}); hidden {err_h:.3g} (atol 2e-3); '
          f'ConvGRU on the same features {err_rnn:.3g} (atol 1e-5)')
    np.testing.assert_allclose(
        np.moveaxis(outs.numpy(), 2, -1), np.asarray(j_outs), rtol=0,
        atol=1e-5)
    np.testing.assert_allclose(nhwc(h_rnn), np.asarray(j_h), rtol=0,
                               atol=1e-5)
