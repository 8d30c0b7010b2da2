"""Port vs JAX: ``Trainer.fit``, ``fine_tune_mit`` and their run
directories.

At ``TINY_UNISAL_CFG`` from the same seeded variables, with in-memory
loaders and the same fixed dropout masks on both sides:

- ``fit``, 2 epochs over DHF1K (dynamic, B=2, T=2) and SALICON (static)
  batches interleaved by numpy's ``default_rng(0)`` on both sides,
  ``train_cnn_after=1`` (a frozen, then a trained backbone),
  ``steps_per_epoch=3`` (the staircase lr decays inside the run),
  ``chkpnt_warmup=0``, lr 1e-4 (see ``LR``): the same files,
  ``Trainer.json`` equal, ``all_scalars.json`` and ``best_val_loss.dat``
  within 1e-4 relative (+1e-5 absolute), ``best_epoch.dat`` equal, the
  checkpoints' and best weights' parameters and statistics within 1e-5
  absolute, their momentum traces within 1e-2 in relative L2 norm (see
  ``TRACE_RTOL``); each package's checkpoint loads in the other exactly.
- ``fine_tune_mit`` at lr 1e-3: kld only, SALICON domain, every source's
  domain parameters trained (a DHF1K parameter no batch uses still
  decays), 2 epochs: the history, the best epoch and value and
  ``weights_best.pkl``.
"""

import json
import pickle

import numpy as np
import pytest
import torch

from test_torch_convgru import randomized
from test_torch_trainer import assert_trees_close
from test_torch_unisal_train import fixed_masks  # noqa: F401 (fixture)
from test_torch_unisal_train import flat, np_tree, tiny_cfg

torch.set_num_threads(1)

RTOL = 1e-4
#: NSS and CC summands of random maps sit near 0.
SCALAR_ATOL = 1e-5
TREE_ATOL = 1e-5
#: Momentum traces sum raw gradients, whose single entries chained steps
#: move most (see ``LR``): held over the whole trace as ||port - JAX|| /
#: ||JAX||.
TRACE_RTOL = 1e-2
#: The learning rate of both runs.  At the default 0.04 both packages'
#: float32 noise is amplified over chained steps (single trace entries of
#: a second step move by more than the per-step tolerance when its start
#: differs by a few ulp, ``test_torch_trainer.py``), and 8 steps leave the
#: scalars percent-level apart.  The optimizer at the default rate is held
#: step by step in ``test_torch_trainer.py``; here the loop is.
LR = 1e-4


class Loader:
    """Zero-arg batch-iterator factory with a known length."""

    def __init__(self, batches):
        self.batches = batches
        self.n_batches = len(batches)

    def __call__(self):
        return iter(self.batches)


def batches(n, t, seed, b=2, hw=64):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = rng.normal(0, 1, (b, t, hw, hw, 3)).astype(np.float32)
        sal = rng.random((b, t, hw, hw, 1)).astype(np.float32) ** 2
        sal /= sal.sum(axis=(2, 3, 4), keepdims=True)
        fix = (rng.random((b, t, hw, hw, 1)) > 0.98).astype(np.float32)
        out.append((x, sal, fix))
    return out


@pytest.fixture(scope='module')
def tree():
    from retargetvid_tpu_torch.convert import state_dict_to_flax
    from retargetvid_tpu_torch.models.init import seeded_init_
    from retargetvid_tpu_torch.models.unisal import UNISAL

    variables = state_dict_to_flax(seeded_init_(UNISAL(**tiny_cfg()), 4))
    variables['batch_stats'] = np_tree(randomized(variables['batch_stats'],
                                                  4))
    return variables


def trainers(tree, **kw):
    from retargetvid_tpu.train.trainer import Trainer as JTrainer
    from retargetvid_tpu_torch.train.trainer import Trainer

    jt = JTrainer(model_cfg=tiny_cfg(), **kw)
    jt.init_state(variables=tree)
    pt = Trainer(model_cfg=tiny_cfg(), device='cpu', **kw)
    pt.init_state(variables=tree)
    return jt, pt


def load_pkl(path):
    with open(path, 'rb') as fp:
        return pickle.load(fp)


def assert_run_dirs_close(port_dir, jax_dir):
    files = sorted(p.name for p in port_dir.iterdir())
    assert files == sorted(p.name for p in jax_dir.iterdir())
    got = json.loads((port_dir / 'all_scalars.json').read_text())
    ref = json.loads((jax_dir / 'all_scalars.json').read_text())
    assert set(got) == set(ref)
    for k in ref:
        assert [e for e, _ in got[k]] == [e for e, _ in ref[k]], k
        np.testing.assert_allclose([v for _, v in got[k]],
                                   [v for _, v in ref[k]], rtol=RTOL,
                                   atol=SCALAR_ATOL, err_msg=k)
    for name in files:
        if name.endswith('.pkl'):
            g, r = load_pkl(port_dir / name), load_pkl(jax_dir / name)
            assert set(g) == set(r), name
            for col in ('params', 'batch_stats'):
                assert_trees_close(g[col], r[col], f'{name} {col}',
                                   atol=TREE_ATOL, rtol=0)
            if 'opt_state' in r:
                gt = dict(flat(g['opt_state']['trace']))
                rt = dict(flat(np_tree(r['opt_state']['trace'])))
                assert set(gt) == set(rt), name
                diff = np.sqrt(sum(np.sum((gt[p] - rt[p]) ** 2) for p in rt))
                err = diff / np.sqrt(sum(np.sum(rt[p] ** 2) for p in rt))
                print(f'{name}: trace relative L2 difference {err:.3g}')
                assert err <= TRACE_RTOL, (name, err)
                assert int(g['opt_state']['count']) == \
                    int(r['opt_state']['count'])
                assert int(g['step']) == int(r['step'])
    return files


def test_fit_two_epochs_matches_jax(tree, fixed_masks, tmp_path):
    from retargetvid_tpu.train.trainer import Trainer as JTrainer
    from retargetvid_tpu_torch.train.trainer import Trainer

    # DHF1K validates on two of its training batches, so the second
    # epoch improves on the first and the best weights are written.
    dhf1k = batches(3, 2, seed=0)
    dataloaders = {
        'DHF1K': {'train': Loader(dhf1k), 'valid': Loader(dhf1k[:2])},
        'SALICON': {'train': Loader(batches(2, 1, seed=2)),
                    'valid': Loader(batches(1, 1, seed=3))},
    }
    kw = dict(num_epochs=2, train_cnn_after=1, steps_per_epoch=3, lr=LR)
    jt, pt = trainers(tree, **kw)
    jdir, pdir = tmp_path / 'jax', tmp_path / 'port'
    jbest = jt.fit(dataloaders, jdir, chkpnt_warmup=0, chkpnt_epochs=1)
    pbest = pt.fit(dataloaders, pdir, chkpnt_warmup=0, chkpnt_epochs=1)
    files = assert_run_dirs_close(pdir, jdir)
    print(f'fit: files {files}; best {pbest} (JAX {jbest})')
    assert {'Trainer.json', 'all_scalars.json', 'chkpnt_epoch0000.pkl',
            'chkpnt_epoch0001.pkl'} <= set(files)
    assert json.loads((pdir / 'Trainer.json').read_text()) == \
        json.loads((jdir / 'Trainer.json').read_text())
    np.testing.assert_allclose(pbest, jbest, rtol=RTOL)
    assert len(pt.history) == len(jt.history) == 2
    assert {'weights_best.pkl', 'best_epoch.dat'} <= set(files)
    if 'best_epoch.dat' in files:
        assert (pdir / 'best_epoch.dat').read_text() == \
            (jdir / 'best_epoch.dat').read_text() == '1'
        np.testing.assert_allclose(
            float((pdir / 'best_val_loss.dat').read_text()),
            float((jdir / 'best_val_loss.dat').read_text()), rtol=RTOL)

    # Each package's checkpoint loads in the other, exactly.
    jt2 = JTrainer.init_from_cfg_dir(pdir)
    jt2.init_state(variables=tree)
    jt2.load_chkpnt(pdir / 'chkpnt_epoch0001.pkl')
    saved = load_pkl(pdir / 'chkpnt_epoch0001.pkl')
    assert_trees_close(np_tree(jt2.state.params), saved['params'], 'params',
                       atol=0, rtol=0)
    assert int(jt2.state.opt_state['count']) == pt.state.opt_state['count']
    pt2 = Trainer.init_from_cfg_dir(jdir, device='cpu')
    pt2.load_chkpnt(jdir / 'chkpnt_epoch0001.pkl')
    from retargetvid_tpu_torch.convert import flax_param_tree
    saved = load_pkl(jdir / 'chkpnt_epoch0001.pkl')
    assert_trees_close(flax_param_tree(pt2.model), saved['params'],
                       'params', atol=0, rtol=0)
    assert_trees_close(flax_param_tree(pt2.model,
                                       pt2.state.opt_state['trace']),
                       np_tree(saved['opt_state']['trace']), 'trace',
                       atol=0, rtol=0)
    assert pt2.state.step == int(saved['step'])


def test_fine_tune_mit_matches_jax(tree, fixed_masks, tmp_path):
    from retargetvid_tpu_torch.convert import flax_param_tree

    dataloaders = {'MIT1003': {'train': Loader(batches(2, 1, seed=4)),
                               'valid': Loader(batches(1, 1, seed=5))}}
    jt, pt = trainers(tree, num_epochs=1)
    jdir, pdir = tmp_path / 'jax', tmp_path / 'port'
    jres = jt.fine_tune_mit(dataloaders, jdir, num_epochs=2, lr=1e-3)
    pres = pt.fine_tune_mit(dataloaders, pdir, num_epochs=2, lr=1e-3)
    files = assert_run_dirs_close(pdir, jdir)
    print(f'fine_tune_mit: {pres} (JAX {jres}), files {files}')
    assert pres[1] == jres[1]
    if jres[0] is not None:
        np.testing.assert_allclose(pres[0], jres[0], rtol=RTOL)
    assert pt.mit1003_finetuned and pt.loss_metrics == ('kld',)
    assert pt.data_sources == ('MIT1003',) and pt.state.step == 4
    # A domain parameter no MIT1003 (SALICON-domain) batch uses still
    # decayed: DHF1K's adaptation moved.
    start = dict(flat(tree['params']))
    moved = dict(flat(flax_param_tree(pt.model)))[
        ('adaptation_dhf1k', 'kernel')]
    assert not np.array_equal(moved, start[('adaptation_dhf1k', 'kernel')])
    ref = dict(flat(np_tree(jt.state.params)))[('adaptation_dhf1k',
                                                 'kernel')]
    np.testing.assert_allclose(moved, ref, rtol=0, atol=1e-7)


def test_copy_code_and_export_scalars(tmp_path):
    """``copy_code`` archives the port's package without caches;
    ``export_scalars`` writes JAX's ``[epoch, value]`` lists."""
    from retargetvid_tpu.train.trainer import Trainer as JTrainer
    from retargetvid_tpu_torch.train.trainer import Trainer

    tr = Trainer(model_cfg=tiny_cfg(), device='cpu')
    dst = tr.copy_code(tmp_path)
    assert (dst / 'config.py').is_file()
    assert (dst / 'train' / 'trainer.py').is_file()
    assert not list(dst.rglob('__pycache__'))
    history = [{'loss': 5.0, 'kld': 5.1}, {'loss': 4.0, 'kld': 4.2}]
    got = tr.export_scalars(tmp_path / 'port', history).read_text()
    ref = JTrainer.export_scalars(None, tmp_path / 'jax', history)
    assert got == ref.read_text()
    assert json.loads(got)['kld'][1] == [1, 4.2]
