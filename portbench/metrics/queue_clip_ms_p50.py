"""``queue_clip_ms_p50``: the median clip time, submission to outputs on
the host, of a traced window that keeps more than one clip in flight, ms."""

import statistics


def read(rec):
    if rec['in_flight'] < 2 or not rec['clip_ms']:
        return None
    return statistics.median(rec['clip_ms'])
