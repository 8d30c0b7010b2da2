"""Host-side video IO (port of ``retargetvid_tpu/io/video.py``)."""
