"""``gather_ms``: the device time per dispatch of the traced card's kernels
whose names contain ``nccl`` (the mesh's all-gather of the packed outputs,
and its wait for the slowest rank, which the NCCL kernel spends on the
card), ms."""


def read(rec):
    p = rec.get('profile')
    if not p:
        return None
    secs = sum(t for name, (t, _) in p['kernels'].items()
               if 'nccl' in name.lower())
    if secs <= 0:
        return None
    return 1e3 * secs / p['dispatches']
