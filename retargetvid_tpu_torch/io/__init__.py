"""Host-side video IO (ports of ``retargetvid_tpu/io/video.py`` and
``io/native_reader.py``)."""
