"""The benchmark of ``retargetvid_tpu_torch`` on one NVIDIA H100 (see
README.md).  Nothing here imports JAX or the JAX package."""
