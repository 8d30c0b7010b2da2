"""``transnet_ms``: the median over the traced window's clips of the program's
``StageTimer`` stage ``transnet`` (CUDA events), ms."""

import statistics


def read(rec):
    times = rec['stages'].get('transnet')
    return statistics.median(times) if times else None
