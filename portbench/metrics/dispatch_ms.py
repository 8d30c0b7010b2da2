"""``dispatch_ms``: the median host-clock span of the program's
``dispatch``/``dispatch_multi`` call over the traced window, ms."""

import statistics


def read(rec):
    return statistics.median(rec['dispatch_ms']) if rec['dispatch_ms'] \
        else None
