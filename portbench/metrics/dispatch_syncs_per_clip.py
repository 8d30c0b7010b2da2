"""``dispatch_syncs_per_clip``: the median over the traced window's clips
of the program's counter ``dispatch_syncs`` (one total per clip)."""

import statistics


def read(rec):
    counts = rec['stages'].get('dispatch_syncs')
    return statistics.median(counts) if counts else None
