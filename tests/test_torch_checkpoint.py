"""Published-weight loading: the port's ``load_unisal_state_dict`` and the
CLI's weight flags vs the JAX package's loaders.

The UNISAL checkpoint is the reference ``state_dict`` layout of
``tests/fixtures/unisal_sd_shapes.json`` with values synthesized from the
key names (``tools/make_conversion_fixtures.py:synth_value``, as
``tests/test_conversion_hermetic.py`` builds it).  The TransNet weights are
a ``{'params': numpy}`` pickle, the layout ``tools/convert_transnet.py``
writes.
"""

import argparse
import importlib.util
import json
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope='module')
def state_dict():
    spec = importlib.util.spec_from_file_location(
        'make_conversion_fixtures',
        ROOT / 'tools' / 'make_conversion_fixtures.py')
    fixgen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fixgen)
    with open(ROOT / 'tests' / 'fixtures' / 'unisal_sd_shapes.json') as fp:
        shapes = json.load(fp)
    return {k: fixgen.synth_value(k, sh, dt) for k, (sh, dt) in shapes.items()}


def _args(**kw):
    return argparse.Namespace(**{'unisal_weights': '', 'transnet_weights': '',
                                 **kw})


def test_unisal_state_dict_matches_jax_loader(state_dict, tmp_path):
    """Every parameter and statistic equals the JAX loader's tree carried
    across by ``convert``; the CLI flag loads the same (a ``.pth`` holding
    ``model_state_dict``); the static forward matches the JAX forward's
    committed golden on its seeded input."""
    from retargetvid_tpu.models.torch_import import load_unisal_variables
    from retargetvid_tpu.models.unisal import UNISAL as JUNISAL
    from retargetvid_tpu_torch.cli import _load_unisal
    from retargetvid_tpu_torch.convert import load_flax_variables
    from retargetvid_tpu_torch.models.torch_import import (
        load_unisal_state_dict,
    )
    from retargetvid_tpu_torch.models.unisal import UNISAL

    # Parameter shapes do not depend on the example input's size.
    variables = load_unisal_variables(
        JUNISAL(), state_dict,
        example_input=jnp.zeros((1, 1, 64, 64, 3), jnp.float32))
    ref = load_flax_variables(
        UNISAL(), jax.tree_util.tree_map(np.asarray, variables),
        skip=('rnn', 'post_rnn')).state_dict()
    with pytest.warns(UserWarning, match='unconsumed'):
        sd = dict(state_dict, extra_key=np.zeros(3, np.float32))
        got = load_unisal_state_dict(UNISAL(), sd).state_dict()
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k

    torch.save({'model_state_dict': {k: torch.from_numpy(np.asarray(v))
                                     for k, v in state_dict.items()}},
               tmp_path / 'weights_best.pth')
    model = _load_unisal(_args(unisal_weights=str(tmp_path /
                                                  'weights_best.pth')))
    for k, v in model.state_dict().items():
        assert torch.equal(v, ref[k]), k

    golden = np.load(ROOT / 'tests' / 'fixtures' /
                     'conversion_goldens.npz')['unisal_logmap']
    x = np.random.default_rng(1).normal(0, 1, (1, 1, 224, 416, 3)).astype(
        np.float32)
    with torch.no_grad():
        out = model.eval()(torch.from_numpy(x), target_size=(140, 250),
                           source='SALICON').numpy()
    err = float(np.abs(out - golden).max())
    print(f'UNISAL forward vs the JAX golden: max |diff| {err:.3g} '
          f'(rtol 1e-3, atol 1e-4)')
    np.testing.assert_allclose(out, golden, rtol=1e-3, atol=1e-4)


def test_unisal_state_dict_missing_or_misshapen(state_dict):
    from retargetvid_tpu_torch.models.torch_import import (
        load_unisal_state_dict,
    )
    from retargetvid_tpu_torch.models.unisal import UNISAL

    sd = dict(state_dict)
    del sd['post_cnn.inv_res.conv.3.weight']
    with pytest.raises(KeyError):
        load_unisal_state_dict(UNISAL(), sd)
    sd = dict(state_dict)
    sd['adaptation_salicon.0.bias'] = np.zeros(2, np.float32)
    with pytest.raises(ValueError, match='shape mismatch'):
        load_unisal_state_dict(UNISAL(), sd)


def test_transnet_weights_pickle(tmp_path):
    """The CLI loads a ``{'params': numpy}`` TransNet pickle; the module
    then gives the JAX model's probabilities."""
    from retargetvid_tpu.models.transnet import TransNetV1 as JTransNet
    from retargetvid_tpu_torch.cli import _load_transnet

    jt = JTransNet()
    params = jax.tree_util.tree_map(np.asarray, jt.init(
        jax.random.PRNGKey(3), jnp.zeros((1, 8, 27, 48, 3), jnp.uint8)))
    with open(tmp_path / 'transnet.pkl', 'wb') as fp:
        pickle.dump(params, fp)
    tn = _load_transnet(_args(transnet_weights=str(tmp_path /
                                                   'transnet.pkl')))
    frames = np.random.default_rng(0).integers(
        0, 255, (2, 12, 27, 48, 3)).astype(np.uint8)
    ref = np.asarray(jax.jit(jt.apply)(params, jnp.asarray(frames)))
    with torch.no_grad():
        out = tn(torch.from_numpy(frames)).numpy()
    err = float(np.abs(out - ref).max())
    print(f'TransNet forward: max |diff| {err:.3g} (atol 1e-5)')
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
