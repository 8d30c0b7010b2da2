"""Port vs JAX: ``ConvGRUCell`` and ``ConvGRU`` (NCHW against NHWC).

Input and hidden width 32, B=1, T=3, a 7x13 grid; every parameter and
BatchNorm statistic is drawn from a seed (the JAX init leaves the
statistics, scales and biases trivial), carried across by ``convert``.
Tolerance 1e-5 absolute.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

C, B, T, H, W = 32, 1, 3, 7, 13
ATOL = 1e-5


def randomized(variables, seed):
    """The JAX tree with every leaf drawn anew from ``seed``: variances in
    [0.5, 1.5], other leaves around their init scale."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        leaf = np.asarray(leaf)
        if name == 'var':
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if name == 'kernel':
            return (leaf + 0.1 * rng.standard_normal(leaf.shape)).astype(
                np.float32)
        base = 1.0 if name == 'scale' or name.startswith('a_') else 0.0
        return (base + 0.2 * rng.standard_normal(leaf.shape)).astype(
            np.float32)

    return jax.tree_util.tree_map_with_path(draw, variables)


def nchw(x):
    """NHWC (..., H, W, C) -> NCHW (..., C, H, W) tensor."""
    return torch.from_numpy(np.moveaxis(np.asarray(x), -1, -3).copy())


def nhwc(x):
    return np.moveaxis(x.detach().numpy(), -3, -1)


def test_cell_matches_jax():
    from retargetvid_tpu.models.convgru import ConvGRUCell as JCell
    from retargetvid_tpu_torch.convert import load_flax_variables
    from retargetvid_tpu_torch.models.convgru import ConvGRUCell

    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    h = rng.standard_normal((B, H, W, C)).astype(np.float32)
    jc = JCell(C, C)
    variables = randomized(jc.init(jax.random.PRNGKey(0), x, h), 1)
    ref = np.asarray(jc.apply(variables, jnp.asarray(x), jnp.asarray(h),
                              source='Hollywood')[0])
    cell = load_flax_variables(ConvGRUCell(C, C), variables)
    with torch.no_grad():
        out = nhwc(cell(nchw(x), nchw(h), 'Hollywood'))
    err = float(np.abs(out - ref).max())
    print(f'ConvGRUCell: max |diff| {err:.3g} (atol {ATOL})')
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize('source', ['DHF1K', 'SALICON'])
@pytest.mark.parametrize('with_h0', [False, True])
def test_sequence_matches_jax(source, with_h0):
    from retargetvid_tpu.models.convgru import ConvGRU as JGRU
    from retargetvid_tpu_torch.convert import load_flax_variables
    from retargetvid_tpu_torch.models.convgru import ConvGRU

    rng = np.random.default_rng(2)
    xs = rng.standard_normal((B, T, H, W, C)).astype(np.float32)
    h0 = rng.standard_normal((B, H, W, C)).astype(np.float32) \
        if with_h0 else None
    jg = JGRU(C, C)
    variables = randomized(jg.init(jax.random.PRNGKey(0), xs), 3)
    outs, hidden = jax.jit(lambda v, xs, h0: jg.apply(
        v, xs, h0=h0, source=source))(
        variables, jnp.asarray(xs), None if h0 is None else jnp.asarray(h0))
    gru = load_flax_variables(ConvGRU(C, C), variables)
    with torch.no_grad():
        got, got_h = gru(nchw(xs), None if h0 is None else nchw(h0),
                         source)
    assert got.shape == (B, T, C, H, W) and got_h.shape == (B, C, H, W)
    err = max(float(np.abs(nhwc(got) - np.asarray(outs)).max()),
              float(np.abs(nhwc(got_h) - np.asarray(hidden)).max()))
    print(f'ConvGRU {source}, h0={with_h0}: max |diff| {err:.3g} '
          f'(atol {ATOL})')
    np.testing.assert_allclose(nhwc(got), np.asarray(outs), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(nhwc(got_h), np.asarray(hidden), rtol=0,
                               atol=ATOL)
    np.testing.assert_array_equal(nhwc(got)[:, -1], nhwc(got_h))
