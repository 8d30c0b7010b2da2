"""``device_idle``: the share of the profiled clips' wall time in which no
operation ran on the device, %."""


def read(rec):
    p = rec.get('profile')
    if not p or p['busy_s'] <= 0:
        return None
    return 100.0 * (1.0 - p['busy_s'] / p['window_s'])
