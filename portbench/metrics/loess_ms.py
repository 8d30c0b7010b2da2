"""``loess_ms``: the median over the traced window's clips of the program's
span ``geometry.loess`` (inside ``geometry``; CUDA events), ms."""

import statistics


def read(rec):
    times = rec['stages'].get('geometry.loess')
    return statistics.median(times) if times else None
