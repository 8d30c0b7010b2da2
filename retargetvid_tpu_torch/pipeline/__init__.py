"""Whole-clip programs (PyTorch ports of ``retargetvid_tpu/pipeline/``)."""
