"""``bn_act_per_clip``: the median over the traced window's clips of the
program's counter ``bn_act`` (one total per clip): launches of the
inference BatchNorm epilogue kernel, one per BatchNorm of UNISAL's static
forward."""

import statistics


def read(rec):
    counts = rec['stages'].get('bn_act')
    return statistics.median(counts) if counts else None
