"""Port vs JAX: ``cli train`` then ``cli score``, and their run directories
across packages.

A synthetic DHF1K tree (3 videos of 12 64x64 frames, the layout of
``tests/test_cli_train.py``), ``TINY_UNISAL_CFG`` as ``--model-cfg``, one
epoch of 2 batches, ``--device cpu`` for the port.  ``Trainer.json`` of
the port's run equals the JAX CLI's; each run directory is scored by the
other package's ``Trainer`` with the same samples (both datasets draw from
``default_rng(0)``), metrics within 1e-4 relative (+1e-5 absolute for the
near-zero NSS and CC); the JAX ``cli score`` reads the port's directory and
prints its metrics at 4 decimals, which agree within 1e-4.
"""

import json

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip('cv2')

torch.set_num_threads(1)

TRAIN_ARGS = ['--sources', 'DHF1K', '--num-epochs', '1', '--batch-size',
              '1', '--seq-len', '2', '--batches-per-epoch', '2',
              '--valid-batches', '1', '--chkpnt-warmup', '0',
              '--chkpnt-epochs', '1']
SCORE_ARGS = ['--source', 'DHF1K', '--batch-size', '1', '--n-batches', '1',
              '--seq-len', '2']


def _saliency_tree(root, n_videos=3, n_frames=12, hw=(64, 64)):
    rng = np.random.default_rng(0)
    for v in range(n_videos):
        vdir = root / 'annotation' / f'{v + 1:04d}'
        for sub in ('images', 'maps', 'fixation'):
            (vdir / sub).mkdir(parents=True)
        for f in range(1, n_frames + 1):
            cv2.imwrite(str(vdir / 'images' / f'{f:04d}.png'),
                        rng.integers(0, 255, (*hw, 3)).astype(np.uint8))
            cv2.imwrite(str(vdir / 'maps' / f'{f:04d}.png'),
                        rng.integers(0, 255, hw).astype(np.uint8))
            cv2.imwrite(str(vdir / 'fixation' / f'{f:04d}.png'),
                        (rng.random(hw) > 0.99).astype(np.uint8) * 255)


def _jax_scores(train_dir):
    """JAX's ``cmd_score`` as a function (it prints, returns nothing);
    the variables are adopted first, which skips an eager init."""
    import pickle

    from retargetvid_tpu.train.data import DHF1KDataset
    from retargetvid_tpu.train.trainer import Trainer

    trainer = Trainer.init_from_cfg_dir(train_dir)
    chkpnt = sorted(train_dir.glob('chkpnt_epoch*.pkl'))[-1]
    with open(chkpnt, 'rb') as fp:
        tree = pickle.load(fp)
    trainer.init_state(variables={k: tree[k]
                                  for k in ('params', 'batch_stats')})
    trainer.load_chkpnt(chkpnt)
    ds = DHF1KDataset(phase='valid', seq_len=2)
    return trainer.score_model([ds.sample(1)], source='DHF1K')


def _printed_scores(text):
    out = {}
    for line in text.splitlines():
        name, _, val = line.strip().partition(': ')
        if name in ('kld', 'nss', 'cc', 'sim', 'aucj'):
            out[name] = float(val)
    return out


def test_cli_train_score_across_packages(tmp_path, monkeypatch, capsys):
    from conftest import TINY_UNISAL_CFG
    from retargetvid_tpu import cli as jcli
    from retargetvid_tpu_torch import cli

    data = tmp_path / 'dhf1k'
    _saliency_tree(data)
    monkeypatch.setenv('DHF1K_DATA_DIR', str(data))
    cfg = ['--model-cfg', json.dumps(TINY_UNISAL_CFG)]
    pdir, jdir = tmp_path / 'port_run', tmp_path / 'jax_run'
    cli.main(['train', '--train-dir', str(pdir), '--device', 'cpu',
              *TRAIN_ARGS, *cfg])
    jcli.main(['train', '--train-dir', str(jdir), *TRAIN_ARGS, *cfg])
    for d in (pdir, jdir):
        assert {p.name for p in d.iterdir()} >= {
            'Trainer.json', 'all_scalars.json', 'chkpnt_epoch0000.pkl'}
    pcfg = json.loads((pdir / 'Trainer.json').read_text())
    assert pcfg == json.loads((jdir / 'Trainer.json').read_text())
    assert pcfg['model_cfg'] == TINY_UNISAL_CFG and 'device' not in pcfg
    scalars = json.loads((pdir / 'all_scalars.json').read_text())
    assert set(scalars) == set(json.loads(
        (jdir / 'all_scalars.json').read_text()))

    capsys.readouterr()
    for d in (pdir, jdir):
        port = cli.main(['score', '--train-dir', str(d), '--device', 'cpu',
                         *SCORE_ARGS])
        ref = _jax_scores(d)
        assert set(port) == set(ref) == {'kld', 'nss', 'cc', 'sim', 'aucj'}
        print(f'{d.name}: port {port}, JAX {ref}')
        for k in ref:
            assert np.isfinite(port[k])
            np.testing.assert_allclose(port[k], ref[k], rtol=1e-4,
                                       atol=1e-5, err_msg=f'{d.name} {k}')
    capsys.readouterr()
    jcli.main(['score', '--train-dir', str(pdir), *SCORE_ARGS])
    printed = _printed_scores(capsys.readouterr().out)
    port = cli.main(['score', '--train-dir', str(pdir), '--device', 'cpu',
                     *SCORE_ARGS])
    assert set(printed) == set(port)
    for k, v in printed.items():
        assert abs(v - port[k]) <= 1e-4, (k, v, port[k])


@pytest.mark.parametrize('sub', ['train', 'score'])
def test_cli_help(sub, capsys):
    from retargetvid_tpu_torch import cli

    with pytest.raises(SystemExit) as e:
        cli.main([sub, '--help'])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert sub in out and '--device' in out
