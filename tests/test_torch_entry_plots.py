"""The port's forward-step entry and cluster scatter against the JAX
package's.

- ``dryrun.entry()``'s step (Lanczos preprocess, static UNISAL, the
  postprocess) on the CPU against ``__graft_entry__.entry()``'s on its 8
  example frames, with the narrow UNISAL of ``TINY_UNISAL_CFG``: JAX's
  entry builds the model it is given (its ``UNISAL`` swapped for the
  narrow one), and its initialized weights reach the port through
  ``convert``; the uint8 maps agree within 1 LSB;
- ``utils/plots.py:plot_cluster_scatter`` writes its file where JAX's does
  (``tests/test_aux_components.py``'s case).
"""

import functools

import numpy as np
import torch

import jax

torch.set_num_threads(1)


def test_entry_matches_jax(monkeypatch):
    import __graft_entry__
    from conftest import TINY_UNISAL_CFG
    from retargetvid_tpu.models import unisal as junisal
    from retargetvid_tpu_torch.convert import load_flax_variables
    from retargetvid_tpu_torch.dryrun import entry
    from retargetvid_tpu_torch.models.unisal import UNISAL

    monkeypatch.setattr(junisal, 'UNISAL', functools.partial(
        junisal.UNISAL, **TINY_UNISAL_CFG))
    jfn, (variables, jframes) = __graft_entry__.entry()
    want = np.asarray(jax.jit(jfn)(variables, jframes))

    model = load_flax_variables(UNISAL(**TINY_UNISAL_CFG), jax.tree_util.
                                tree_map(np.asarray, variables),
                                skip=('rnn', 'post_rnn'))
    fn, (model, frames) = entry(device='cpu', model=model)
    np.testing.assert_array_equal(frames.numpy(), np.asarray(jframes))
    got = fn(model, frames).numpy()
    assert got.shape == want.shape == (8, 140, 250)
    assert got.dtype == want.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    print(f'{int((diff > 0).sum())} of {diff.size} pixels differ, max '
          f'{diff.max()} LSB')
    assert diff.max() <= 1


def test_entry_defaults_to_the_seeded_full_width_model():
    from retargetvid_tpu_torch.dryrun import entry

    _, (model, frames) = entry(device='cpu')
    assert model.cnn.features_0.conv.weight.shape[0] == 32
    assert frames.shape == (8, 140, 250, 3) and frames.dtype == torch.uint8


def test_cluster_scatter_writes_its_file(tmp_path):
    from retargetvid_tpu.utils.plots import plot_cluster_scatter as jplot
    from retargetvid_tpu_torch.utils.plots import plot_cluster_scatter

    rng = np.random.default_rng(0)
    before = (rng.random((20, 30)) > 0.8) * 200.0
    after = before.copy()
    after[:10] = 0
    for name, plot in (('port', plot_cluster_scatter), ('jax', jplot)):
        path = tmp_path / f'{name}_scatter.png'
        plot(before, after, str(path))
        assert path.stat().st_size > 0
        plot(before, after, '')                  # no file name: no plot
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        ['jax_scatter.png', 'port_scatter.png']
