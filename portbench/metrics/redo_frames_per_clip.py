"""``redo_frames_per_clip``: the median over the traced window's clips
of the program's counter ``redo_frames`` (one total per clip)."""

import statistics


def read(rec):
    counts = rec['stages'].get('redo_frames')
    return statistics.median(counts) if counts else None
