"""Models of the crop pipeline (PyTorch ports of ``retargetvid_tpu/models/``)."""
