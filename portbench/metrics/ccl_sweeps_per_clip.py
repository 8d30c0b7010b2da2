"""``ccl_sweeps_per_clip``: the median over the traced window's clips
of the program's counter ``ccl_sweeps`` (one total per clip)."""

import statistics


def read(rec):
    counts = rec['stages'].get('ccl_sweeps')
    return statistics.median(counts) if counts else None
