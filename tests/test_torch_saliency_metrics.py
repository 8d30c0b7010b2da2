"""Port vs JAX: the numpy saliency metrics are bit-equal.

``normalize_map``, ``auc_judd``, ``auc_shuffled`` and ``sim`` of the port's
own copy (``retargetvid_tpu_torch/eval/saliency_metrics.py``) against the
JAX package's on seeded maps, including constant maps, empty fixation
maps and all-zero maps (NaN on both sides).
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def cases():
    rng = np.random.default_rng(0)
    sal = rng.random((30, 40)).astype(np.float32) ** 2
    gt = rng.random((30, 40)).astype(np.float32)
    fix = (rng.random((30, 40)) > 0.95).astype(np.float32)
    other = (rng.random((30, 40)) > 0.9).astype(np.float32)
    return {
        'random': (sal, gt, fix, other),
        'constant_map': (np.full((30, 40), 0.5, np.float32), gt, fix, other),
        'no_fixation': (sal, gt, np.zeros_like(fix), other),
        'zero_maps': (np.zeros_like(sal), np.zeros_like(gt), fix,
                      np.zeros_like(other)),
    }


@pytest.mark.parametrize('case', list(cases()))
def test_metrics_bit_equal(case):
    from retargetvid_tpu.eval import saliency_metrics as jm
    from retargetvid_tpu_torch.eval import saliency_metrics as tm

    sal, gt, fix, other = cases()[case]
    for name, args in (('auc_judd', (sal, fix)), ('sim', (sal, gt)),
                       ('auc_shuffled', (sal, fix, other))):
        ref = getattr(jm, name)(*args)
        got = getattr(tm, name)(*args)
        assert (np.isnan(ref) and np.isnan(got)) or ref == got, \
            (name, ref, got)
    np.testing.assert_array_equal(tm.normalize_map(sal),
                                  jm.normalize_map(sal))
