"""``launches_per_clip``: device kernels per clip over the profiled
clips."""


def read(rec):
    p = rec.get('profile')
    if not p or not p['launches']:
        return None
    return p['launches'] / p['clips']
