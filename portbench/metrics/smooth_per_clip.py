"""``smooth_per_clip``: the median over the traced window's clips of the
program's counter ``saliency_smooth`` (one total per clip): launches of
the smoothing-tail kernel, one per static UNISAL forward (nearest resize,
edge pad and both smoothing factors)."""

import statistics


def read(rec):
    counts = rec['stages'].get('saliency_smooth')
    return statistics.median(counts) if counts else None
