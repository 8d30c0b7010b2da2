from retargetvid_tpu_torch.parallel.mesh import (
    batch_sharding,
    make_mesh,
    param_shardings,
)

__all__ = ["make_mesh", "batch_sharding", "param_shardings"]
