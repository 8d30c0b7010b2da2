"""``Trainer.fit(mesh=...)`` end to end and the port's multi-device dry
run, on CPU gloo ranks.

- One epoch of ``fit`` (train, valid, best-weights selection, the
  checkpoint rule) on a (2, 1, 2) mesh of 4 ranks, as JAX's
  ``test_fit_mesh_smoke``: a finite score, ``chkpnt_epoch0000.pkl`` and
  ``all_scalars.json`` written, ``tr.mesh`` the mesh; then, on the
  tp-trained trainer, ``score_model`` and ``run_inference`` (SALICON, per
  frame) equal the port's single-device trainer loaded from that
  checkpoint.
- ``retargetvid_tpu_torch.dryrun.dryrun_multichip(4)``: the (1, 2, 2)
  train step with a finite loss and the sharded one-shot swap check.
"""

import numpy as np
import torch

from test_torch_parallel_mesh import ok_results, run_ranks
from test_torch_train_mesh import TINY, make_batch

torch.set_num_threads(1)

FRAMES = np.random.default_rng(9).integers(0, 255, (5, 64, 96, 3),
                                           dtype=np.uint8)


METRICS = ('kld', 'nss', 'cc', 'sim')


def _head(batch):
    return tuple(a[:2] for a in batch)


class _Loader:
    n_batches = 1

    def __init__(self, batch):
        self.batch = batch

    def __call__(self):
        return iter([self.batch])


def fit_rank(rank, train_dir):
    from retargetvid_tpu_torch.parallel.mesh import make_mesh
    from retargetvid_tpu_torch.train.trainer import Trainer

    batch = make_batch(64)
    mesh = make_mesh(axis_sizes=(2, 1, 2), device='cpu')
    tr = Trainer(num_epochs=1, steps_per_epoch=1, model_cfg=TINY,
                 device='cpu')
    loader = _Loader(batch)
    score = tr.fit({'DHF1K': {'train': loader, 'valid': loader}},
                   train_dir, mesh=mesh, chkpnt_warmup=0, chkpnt_epochs=1)
    return {'score': score, 'is_mesh': tr.mesh is mesh,
            'split': len(tr._tp_dims),
            'scores': tr.score_model([_head(batch)], metrics=METRICS),
            'maps': tr.run_inference(FRAMES, source='SALICON')[0]}


def test_fit_mesh_smoke(tmp_path):
    from retargetvid_tpu_torch.train.trainer import Trainer

    run = tmp_path / 'run'
    res = ok_results(run_ranks(fit_rank, 4, tmp_path, run))
    assert (run / 'chkpnt_epoch0000.pkl').exists()
    assert (run / 'all_scalars.json').exists()
    single = Trainer(model_cfg=TINY, device='cpu')
    single.load_chkpnt(run / 'chkpnt_epoch0000.pkl')
    want_scores = single.score_model([_head(make_batch(64))],
                                     metrics=METRICS)
    want_maps = single.run_inference(FRAMES, source='SALICON')[0]
    for r, out in enumerate(res):
        assert np.isfinite(out['score']) and out['is_mesh'], r
        assert out['split'] > 0, r
        assert out['scores'].keys() == want_scores.keys()
        for k, v in want_scores.items():
            np.testing.assert_allclose(out['scores'][k], v, rtol=1e-6,
                                       err_msg=f'rank {r} {k}')
        np.testing.assert_array_equal(out['maps'], want_maps)


def test_dryrun_multichip_four_ranks():
    from retargetvid_tpu_torch.dryrun import dryrun_multichip

    rec = dryrun_multichip(4, timeout_s=240.0)
    assert rec['mesh'] == {'dp': 1, 'sp': 2, 'tp': 2}
    assert rec['backend'] == ('nccl' if torch.cuda.device_count() >= 4
                              else 'gloo')
    assert rec['batch'] == [2, 2, 64, 64] and rec['tp_split_weights'] > 0
    assert np.isfinite(rec['metrics']['loss'])
    assert rec['swap_check']['follow_the_clip']
