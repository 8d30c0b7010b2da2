"""The benchmark's general harness: one run of one cell.

Everything specific lives in files found by name (README.md): the cell's
configuration (``configs/``) and traffic mix (``traffic/``) as data, the
entry path's adapter (``paths/<path>.py``), one reader per per-layer metric
(``metrics/<metric>.py``), the reference (``reference/``) and the counts
(``counts/``).  This module reads ``BENCHMARK.json``, makes the run's
inputs from the seed, warms up, drives the closed loop for the window,
reads the trace in a traced run, checks the outputs against the reference
and prints the result line.
"""

from __future__ import annotations

import argparse
import collections
import importlib.util
import json
import sys
import time
import traceback
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: Top-level module names that may not be loaded when the window closes.
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'retargetvid_tpu')
#: Steady clips the traced run profiles after its window.
PROFILED_CLIPS = 3


class NoResult(Exception):
    """The run ends without a result line, with this message."""


def load_module(kind: str, name: str):
    """``portbench/<kind>/<name>.py`` as a module."""
    path = HERE / kind / f'{name}.py'
    if not path.is_file():
        raise NoResult(f'no {kind} file {path.relative_to(ROOT)}')
    spec = importlib.util.spec_from_file_location(
        f'portbench.{kind}.{name}', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(workload: str, spec: dict | None = None):
    """(BENCHMARK.json, its workload entry, the configuration's data, the
    traffic's data) of a cell."""
    if spec is None:
        spec = json.loads((ROOT / 'BENCHMARK.json').read_text())
    cells = {w['name']: w for w in spec['workloads']}
    if workload not in cells:
        raise NoResult(f'unknown workload {workload!r}')
    cell = cells[workload]
    conf = {c['name']: c for c in spec['configs']}[cell['config']]
    cfg = json.loads((ROOT / conf['file']).read_text())
    traffic = json.loads(
        (HERE / 'traffic' / f'{cell["traffic"]}.json').read_text())
    return spec, cell, cfg, traffic


def metric_names(spec: dict, workload: str, section: str) -> list:
    return [m['name'] for m in spec[section]
            if workload in m.get('workloads', [workload])]


def check_card(chips: int) -> None:
    import torch
    if not torch.cuda.is_available():
        raise NoResult('no CUDA device: this benchmark runs only on a GPU')
    if torch.cuda.device_count() < chips:
        raise NoResult(f'the cell needs {chips} GPUs, '
                       f'{torch.cuda.device_count()} visible')


def forbidden_modules() -> list:
    return sorted({m.split('.')[0] for m in sys.modules} & set(FORBIDDEN))


def _sync(device) -> None:
    import torch
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def closed_loop(adapter, pool, seconds: float, in_flight: int, keep=(),
                on_error=None, clips: int | None = None) -> dict:
    """Keep ``in_flight`` clips dispatched, cycling over ``pool``, collect
    them in order; submit nothing after ``seconds`` (or after ``clips``
    clips, where given), then drain.  The window runs from the first
    submission to the last completion."""
    import torch
    pending = collections.deque()
    rec = {'clip_ms': [], 'dispatch_ms': [], 'collect_ms': [],
           'attempted': 0, 'failed': 0, 'frames': 0,
           'outputs': {i: [] for i in keep}}
    k = 0
    t_start = time.perf_counter()
    deadline = t_start + seconds
    with torch.profiler.record_function('portbench.window'):
        while True:
            while len(pending) < in_flight and (
                    k < clips if clips is not None
                    else time.perf_counter() < deadline):
                idx = k % len(pool)
                k += 1
                rec['attempted'] += 1
                t0 = time.perf_counter()
                try:
                    with torch.profiler.record_function('portbench.dispatch'):
                        ticket = adapter.dispatch(pool[idx])
                except Exception:
                    rec['failed'] += 1
                    if on_error:
                        on_error()
                    continue
                rec['dispatch_ms'].append((time.perf_counter() - t0) * 1e3)
                pending.append((idx, t0, ticket))
            if not pending:
                break
            idx, t0, ticket = pending.popleft()
            t1 = time.perf_counter()
            try:
                with torch.profiler.record_function('portbench.collect'):
                    out = adapter.collect(ticket)
            except Exception:
                rec['failed'] += 1
                if on_error:
                    on_error()
                continue
            t2 = time.perf_counter()
            rec['collect_ms'].append((t2 - t1) * 1e3)
            rec['clip_ms'].append((t2 - t0) * 1e3)
            rec['frames'] += adapter.frames_per_clip
            if idx in rec['outputs']:
                rec['outputs'][idx].append(out)
    rec['window_s'] = time.perf_counter() - t_start
    rec['clips'] = len(rec['clip_ms'])
    return rec


def end_to_end(name: str, rec: dict, setup_s: float):
    """An end-to-end metric by name: ``frames_per_s``, ``setup_s`` or
    ``clip_ms_p<q>``, the q-th percentile of the window's clip times."""
    if name == 'setup_s':
        return setup_s
    if name == 'frames_per_s':
        return rec['frames'] / rec['window_s']
    if name.startswith('clip_ms_p') and rec['clip_ms']:
        return float(np.percentile(rec['clip_ms'], float(name[9:])))
    raise NoResult(f'no definition for the end-to-end metric {name!r}')


def merged(base: dict, over: dict | None) -> dict:
    """``base`` with ``over``'s keys, nested dicts merged key by key."""
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = merged(out[k], v) if isinstance(v, dict) and \
            isinstance(out.get(k), dict) else v
    return out


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        t_process: float, device=None, spec=None, overrides=None,
        control: bool = False, clips: int | None = None) -> dict:
    """One run of a cell; returns the result dict.  ``device=None`` means
    the GPU, which must be there.  ``overrides`` (``{'traffic': ...,
    'config': ...}``) replaces keys of the cell's data (the CPU tests'
    small sizes); ``control`` also reads the control; ``clips`` runs that
    many clips instead of a window of ``seconds``."""
    import torch
    spec, cell, cfg, traffic = load_cell(workload, spec)
    traffic = merged(traffic, (overrides or {}).get('traffic'))
    cfg = merged(cfg, (overrides or {}).get('config'))
    if device is None:
        check_card(int(cell['chips']))
        device = torch.device('cuda', 0)
    device = torch.device(device)
    torch.set_num_threads(2)
    path = load_module('paths', traffic['path'])
    failures = []

    def log_failure():
        """The first failed clip's traceback, on standard error."""
        if not failures:
            traceback.print_exc()
        failures.append(1)

    # Set-up: the program and its weights, the clip pool, one warm clip.
    marks = [('start', time.perf_counter())]
    adapter = path.Adapter(cfg, traffic, seed, device)
    marks.append(('program', time.perf_counter()))
    pool = adapter.make_pool(int(traffic['pool']))
    _sync(device)
    marks.append(('pool', time.perf_counter()))
    rng = np.random.default_rng(seed % (2 ** 63))
    keep = sorted(rng.choice(len(pool), size=int(traffic['check_clips']),
                             replace=False).tolist())
    adapter.collect(adapter.dispatch(pool[0]))
    _sync(device)
    marks.append(('warm clip', time.perf_counter()))
    setup_s = marks[-1][1] - t_process
    print('setup_s ' + ', '.join(
        f'{name} {t1 - t0:.3f}' for (_, t0), (name, t1)
        in zip([('', t_process)] + marks, marks)), file=sys.stderr)

    timer = adapter.make_timer() if trace and device.type == 'cuda' else None
    adapter.set_timer(timer)
    rec = closed_loop(adapter, pool, seconds, int(traffic['in_flight']),
                      keep, log_failure, clips)
    adapter.set_timer(None)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == 'cuda' else 0)
    rec.update(in_flight=int(traffic['in_flight']),
               frames_per_clip=adapter.frames_per_clip,
               stages=timer.times_ms() if timer is not None else {})

    profile = None
    if trace:
        from portbench import trace as tracing
        profile = tracing.profile_clips(
            lambda: closed_loop(adapter, pool, 0.0,
                                int(traffic['in_flight']), (),
                                log_failure, clips=PROFILED_CLIPS),
            PROFILED_CLIPS, device)
        rec['profile'] = profile
        rec.update(adapter.counts())

    # The check, once the program is gone.
    adapter.release()
    if device.type == 'cuda':
        torch.cuda.empty_cache()
    checks = adapter.check(rec['outputs'], [pool[i] for i in keep],
                           control=control)
    readings = checks.pop('readings', None)
    del pool
    correct = (all(c['value'] <= c['limit'] for c in checks.values())
               and all(rec['outputs'][i] for i in keep))

    section = 'per_layer' if trace else 'end_to_end'
    metrics = {}
    units = {m['name']: m['unit'] for m in spec[section]}
    for name in metric_names(spec, workload, section):
        value = (end_to_end(name, rec, setup_s) if not trace
                 else load_module('metrics', name).read(rec))
        if value is not None:
            metrics[name] = {'value': float(value), 'unit': units[name]}

    dev_info = {'platform': 'gpu' if device.type == 'cuda' else 'cpu',
                'kind': (torch.cuda.get_device_name(device)
                         if device.type == 'cuda' else 'cpu'),
                'count': 1, 'memory_peak_bytes': int(peak)}
    result = {'correct': bool(correct), 'attempted': rec['attempted'],
              'failed': rec['failed'], 'metrics': metrics,
              'device': dev_info}
    if trace and profile is not None:
        dev_info['busy_s'] = profile['busy_s']
        dev_info['window_s'] = profile['window_s']
        result['breakdown'] = {'device_ops': profile['device_ops'],
                               'idle_gaps': profile['idle_gaps']}
    result['checks'] = checks
    if readings is not None:
        result['readings'] = readings
    return result


def main(argv, t_process: float) -> int:
    ap = argparse.ArgumentParser(prog='portbench/run.py')
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        result = run(args.workload, args.seed, args.seconds,
                     bool(args.trace), t_process=t_process)
        bad = forbidden_modules()
        if bad:
            raise NoResult('modules of JAX or the JAX package are loaded: '
                           + ', '.join(bad))
    except NoResult as e:
        print(f'portbench: {e}', file=sys.stderr, flush=True)
        return 2
    for name, c in result['checks'].items():
        print(f'check {name} {c["value"]!r} limit {c["limit"]!r}',
              file=sys.stderr)
    print(f'correct {result["correct"]}', file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0
