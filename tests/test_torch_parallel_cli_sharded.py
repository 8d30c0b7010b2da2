"""``cli benchmark --mesh 2 --device cpu`` (``ShardedClipRunner`` over
``read_video_structure`` clips) in two processes against the JAX CLI's
sequential ``cli benchmark``: box files within 1 px on under 5% of the
boxes, ``_sharded_info`` lines with ``sharded dp=2``; see
``test_torch_parallel_cli.py``.
"""

import torch

from test_torch_parallel_cli import check_benchmark_mesh
from test_torch_parallel_cli import setup  # noqa: F401  (the fixture)

torch.set_num_threads(1)


def test_benchmark_mesh_sharded(setup, monkeypatch, capsys,  # noqa: F811
                                tmp_path):
    check_benchmark_mesh(setup, monkeypatch, capsys, tmp_path, oneshot=False)
