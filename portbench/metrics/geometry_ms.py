"""``geometry_ms``: the median over the traced window's clips of the program's
``StageTimer`` stage ``geometry`` (CUDA events), ms."""

import statistics


def read(rec):
    times = rec['stages'].get('geometry')
    return statistics.median(times) if times else None
