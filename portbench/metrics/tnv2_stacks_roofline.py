"""``tnv2_stacks_roofline``: the least time TransNet V2's three stacks
need (their conv FLOPs at the clip's window plan, counted from the layers'
shapes, ``counts/transnetv2.py:stacks``, over the card's published peak in
the stacks' dtype) over the median of the program's span
``transnet.stacks`` (CUDA events), %."""

import statistics

from portbench.counts.flops import PEAK_FLOPS


def read(rec):
    times = rec['stages'].get('transnet.stacks')
    if not times or not rec.get('transnet_stack_flops'):
        return None
    least = sum(f / PEAK_FLOPS[dtype]
                for f, dtype in rec['transnet_stack_flops'])
    return 100.0 * least / (statistics.median(times) / 1e3)
