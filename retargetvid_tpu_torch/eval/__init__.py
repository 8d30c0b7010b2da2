"""RetargetVid benchmark evaluation (port of ``retargetvid_tpu/eval/``)."""
