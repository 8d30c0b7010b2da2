"""Port vs JAX: TransNetV1 and UNISAL (static), through ``convert``.

The hermetic goldens are the ones the JAX package is held to
(``tests/test_conversion_hermetic.py``): weights synthesised from the
checkpoint names alone, converted to the JAX trees, carried across.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

FIXTURES = Path(__file__).parent / 'fixtures'
TOOLS = Path(__file__).parent.parent / 'tools'


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(name, TOOLS / f'{name}.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope='module')
def fixgen():
    return _load_tool('make_conversion_fixtures')


@pytest.fixture(scope='module')
def goldens():
    return np.load(FIXTURES / 'conversion_goldens.npz')


def _np_tree(variables):
    return jax.tree_util.tree_map(np.asarray, variables)


def test_transnet_hermetic_golden(fixgen, goldens):
    from retargetvid_tpu_torch.convert import load_flax_variables
    from retargetvid_tpu_torch.models.transnet import TransNetV1

    conv = _load_tool('convert_transnet')
    with open(FIXTURES / 'transnet_tiny_shapes.json') as fp:
        shapes = json.load(fp)
    tensors = {n: fixgen.synth_value(n, sh) for n, sh in shapes.items()}
    variables = conv.map_variables(tensors.__getitem__)
    model = load_flax_variables(TransNetV1(**fixgen.TN_CFG), variables)
    frames = np.random.default_rng(0).integers(
        0, 255, (2, 12, 27, 48, 3)).astype(np.uint8)
    with torch.no_grad():
        probs = model(torch.from_numpy(frames)).numpy()
    err = np.abs(probs - goldens['transnet_probs']).max()
    print(f'transnet golden: max |diff| {err:.3g} (rtol 1e-4, atol 1e-5)')
    np.testing.assert_allclose(probs, goldens['transnet_probs'],
                               rtol=1e-4, atol=1e-5)


def test_unisal_hermetic_golden(fixgen, goldens):
    """Full-width UNISAL, 224x416, SALICON, static."""
    from retargetvid_tpu.models.torch_import import convert_unisal_state_dict
    from retargetvid_tpu_torch.convert import load_flax_variables
    from retargetvid_tpu_torch.models.unisal import UNISAL

    with open(FIXTURES / 'unisal_sd_shapes.json') as fp:
        shapes = json.load(fp)
    sd = {k: fixgen.synth_value(k, sh, dt) for k, (sh, dt) in shapes.items()}
    params, stats, _ = convert_unisal_state_dict(sd, smoothing_rank=8)
    model = load_flax_variables(
        UNISAL(), {'params': params, 'batch_stats': stats},
        skip=('rnn', 'post_rnn'))
    x = np.random.default_rng(1).normal(
        0, 1, (1, 1, 224, 416, 3)).astype(np.float32)
    with torch.no_grad():
        out = model(torch.from_numpy(x), target_size=(140, 250),
                    source='SALICON').numpy()
    err = np.abs(out - goldens['unisal_logmap']).max()
    print(f'unisal golden: max |diff| {err:.3g} (rtol 1e-3, atol 1e-4)')
    np.testing.assert_allclose(out, goldens['unisal_logmap'],
                               rtol=1e-3, atol=1e-4)


def test_transnet_random_init_full_width():
    from retargetvid_tpu.models.transnet import TransNetV1 as JTransNet
    from retargetvid_tpu_torch.convert import load_flax_variables
    from retargetvid_tpu_torch.models.transnet import TransNetV1

    jm = JTransNet()
    params = _np_tree(jm.init(jax.random.PRNGKey(0),
                              jnp.zeros((1, 8, 27, 48, 3), jnp.uint8)))
    frames = np.random.default_rng(1).integers(
        0, 255, (1, 20, 27, 48, 3)).astype(np.uint8)
    ref = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(frames)))
    model = load_flax_variables(TransNetV1(), params)
    with torch.no_grad():
        out = model(torch.from_numpy(frames)).numpy()
    err = np.abs(out - ref).max()
    print(f'transnet random init: max |diff| {err:.3g} (atol 1e-5)')
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def test_unisal_random_init_tiny():
    from conftest import TINY_UNISAL_CFG
    from retargetvid_tpu.models.unisal import UNISAL as JUNISAL
    from retargetvid_tpu_torch.convert import load_flax_variables
    from retargetvid_tpu_torch.models.unisal import UNISAL

    jm = JUNISAL(**TINY_UNISAL_CFG)
    variables = _np_tree(jm.init(
        jax.random.PRNGKey(1), jnp.zeros((1, 1, 224, 416, 3), jnp.float32),
        static=True))
    x = np.random.default_rng(0).normal(
        0, 1, (2, 1, 224, 416, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda v, x: jm.apply(
        v, x, target_size=(140, 250), source='SALICON', static=True)[0])(
        variables, jnp.asarray(x)))
    model = load_flax_variables(UNISAL(**TINY_UNISAL_CFG), variables,
                                skip=('rnn', 'post_rnn'))
    with torch.no_grad():
        out = model(torch.from_numpy(x), target_size=(140, 250),
                    source='SALICON').numpy()
    assert out.shape == ref.shape == (2, 1, 140, 250, 1)
    err = np.abs(out - ref).max()
    print(f'unisal tiny random init: max |diff| {err:.3g} (atol 1e-4)')
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)


def test_convert_rejects_a_mismatched_tree():
    from retargetvid_tpu.models.transnet import TransNetV1 as JTransNet
    from retargetvid_tpu_torch.convert import load_flax_variables
    from retargetvid_tpu_torch.models.transnet import TransNetV1

    jm_params = _np_tree(JTransNet(f=2, d=16).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4, 27, 48, 3), jnp.uint8)))
    with pytest.raises(ValueError, match='shape mismatch'):
        load_flax_variables(TransNetV1(f=4, d=16), jm_params)
    del jm_params['params']['dense2']
    with pytest.raises(KeyError, match='missing'):
        load_flax_variables(TransNetV1(f=2, d=16), jm_params)
