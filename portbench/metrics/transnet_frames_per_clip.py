"""``transnet_frames_per_clip``: the median over the traced window's clips
of the program's counter ``transnet_frames``, the frames TransNet's
forward processed (one total per clip): 1,100 for a 480-frame clip in the
100/50 window plan."""

import statistics


def read(rec):
    counts = rec['stages'].get('transnet_frames')
    return statistics.median(counts) if counts else None
