"""``tnv2_stacks_ms``: the median over the traced window's clips of the
program's span ``transnet.stacks`` (TransNet V2's three stacks of
separable dilated Conv3D cells; CUDA events), ms."""

import statistics


def read(rec):
    times = rec['stages'].get('transnet.stacks')
    return statistics.median(times) if times else None
