"""``chunks_ms``: the median over the traced window's clips of the program's
``StageTimer`` stage ``chunks`` (CUDA events), ms."""

import statistics


def read(rec):
    times = rec['stages'].get('chunks')
    return statistics.median(times) if times else None
