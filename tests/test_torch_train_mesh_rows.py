"""Mesh training of the port on meshes whose 1/32 level leaves sp ranks
without rows, against the JAX package's single-device ``make_train_step``.

``tests/test_torch_train_mesh_jax.py``'s check (one DHF1K step, backbone
trained, every dropout mask fixed on both sides; the loss and each summand
within 1e-5 relative (1e-5 absolute), every parameter and BatchNorm
statistic within 1e-5 absolute + 1e-4 relative, on every rank) on the
(1,4,1) mesh at H=64 (1/32: 1, 0, 1, 0 rows per sp rank) and H=96 (1, 1,
1, 0; the seed-4 batch, as that file explains).  The same meshes against
the port's single-device step are cases of
``tests/test_torch_train_mesh.py``; they live in this file to keep each
file's time on one worker near 90 s.
"""

import pytest

from test_torch_train_mesh import ROW_CASES, case_ids
from test_torch_train_mesh_jax import (  # noqa: F401  (fixtures)
    assert_mesh_step_matches_jax,
    jax_step,
    tree,
)


@pytest.mark.parametrize('sizes, h', ROW_CASES, ids=case_ids(ROW_CASES))
def test_mesh_step_without_rows_matches_jax(sizes, h, tree, jax_step,
                                            tmp_path):
    assert_mesh_step_matches_jax(sizes, h, tree, jax_step, tmp_path)
