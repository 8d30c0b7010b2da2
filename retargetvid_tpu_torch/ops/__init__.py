"""Array operations of the crop pipeline (PyTorch ports of ``retargetvid_tpu/ops/``)."""
