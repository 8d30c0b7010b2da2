"""``unisal_ms``: the median over the traced window's clips of the program's
``StageTimer`` stage ``unisal`` (CUDA events), ms."""

import statistics


def read(rec):
    times = rec['stages'].get('unisal')
    return statistics.median(times) if times else None
