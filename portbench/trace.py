"""The traced run's profiler pass and its reduction.

``torch.profiler`` (CPU and CUDA activities) over a few steady clips after
the window.  From its raw events: every device operation (kernels, copies,
sets) by name, the device's busy time as the union of their intervals, the
kernel count, and each idle gap between device operations attributed to
the outermost ``aten::`` operation the host was in at the gap's middle
(``host`` where it was in none).
"""

from __future__ import annotations

import bisect
import collections
import time

#: Device-timeline events that are not operations: the runtime's and the
#: benchmark's own ``record_function`` ranges.
_NOT_OPS = ('cudaLaunch', 'cudaStream', 'cudaDevice', 'cudaEvent',
            'portbench.')


def _ns(ev, what: str) -> float:
    for attr in (f'{what}_ns', f'{what}_us'):
        fn = getattr(ev, attr, None)
        if fn is not None:
            v = fn()
            return float(v) if attr.endswith('_ns') else float(v) * 1e3
    raise AttributeError(what)


def _events(prof):
    """(device ops, host ops) as (name, start ns, end ns, is_kernel)."""
    from torch.autograd import DeviceType
    dev, host = [], []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        start = _ns(ev, 'start')
        end = start + _ns(ev, 'duration')
        if ev.device_type() == DeviceType.CUDA:
            if not name.startswith(_NOT_OPS):
                low = name.lower()
                is_kernel = not (low.startswith('memcpy')
                                 or low.startswith('memset'))
                dev.append((name, start, end, is_kernel))
        elif name.startswith('aten::'):
            host.append((name, start, end))
    return dev, host


def _union(intervals) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _outermost(host) -> list:
    """The host ops not inside another, sorted by start."""
    out = []
    for name, s, e in sorted(host, key=lambda h: (h[1], -h[2])):
        if out and s < out[-1][2] and e <= out[-1][2]:
            continue
        out.append((name, s, e))
    return out


def reduce(dev, host, window_s: float, clips: int) -> dict:
    by_name = collections.defaultdict(float)
    for name, s, e, _ in dev:
        by_name[name] += (e - s) * 1e-9
    busy = _union([(s, e) for _, s, e, _ in dev])
    busy_s = sum(e - s for s, e in busy) * 1e-9
    top = _outermost(host)
    starts = [h[1] for h in top]
    gaps = collections.defaultdict(float)
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        mid = 0.5 * (e0 + s1)
        i = bisect.bisect_right(starts, mid) - 1
        what = top[i][0] if i >= 0 and top[i][2] >= mid else 'host'
        gaps[what] += (s1 - e0) * 1e-9
    kernels = collections.defaultdict(lambda: [0.0, 0])
    for name, s, e, is_kernel in dev:
        if is_kernel:
            kernels[name][0] += (e - s) * 1e-9
            kernels[name][1] += 1
    return {
        'busy_s': busy_s, 'window_s': window_s, 'clips': clips,
        'launches': sum(v[1] for v in kernels.values()),
        'kernels': {k: tuple(v) for k, v in kernels.items()},
        'device_ops': [[k, v] for k, v in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:10]],
        'idle_gaps': [[k, v] for k, v in sorted(
            gaps.items(), key=lambda kv: -kv[1])[:10]],
    }


def profile_clips(fn, dispatches: int, device, per_card: int = 1) -> dict:
    """Run ``fn`` (the closed loop over ``dispatches`` dispatches) under
    the profiler and reduce its events; ``clips`` is the clips the traced
    card computed, ``per_card`` of them in each dispatch."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == 'cuda':
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        if device.type == 'cuda':
            torch.cuda.synchronize(device)
        window_s = time.perf_counter() - t0
    dev, host = _events(prof)
    out = reduce(dev, host, window_s, dispatches * per_card)
    out['dispatches'] = dispatches
    return out
