"""CPU runs of the harness at a small size: the program against the
reference, the result line, the frozen counts, the faults that must come
out as not correct, the control, and the run without a card.

The models are cut in width here (TransNet F=2, D=16; UNISAL's backbone at
0.25) and the clips to 48 frames of 72x128; the benchmark itself runs the
configurations' widths on the card.

    python -m pytest portbench -q
"""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from portbench import core
from portbench.counts import bytes as kbytes
from portbench.counts import flops
from portbench.reference.transnet import TransNetV1 as RefTransNet
from portbench.reference.unisal import UNISAL as RefUNISAL

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parent.parent
SMALL = {'frames': 48, 'height': 72, 'width': 128, 'pool': 1,
         'check_clips': 1}
SMALL_MODELS = {'transnet': {'F': 2, 'D': 16},
                'unisal': {'cnn_widen_factor': 0.25}}
#: Float32 everywhere: the program on the CPU then runs the reference's
#: arithmetic, and every number reads 0.
FLOAT32 = {'transnet': {'dtype': 'float32'},
           'unisal': {'input_dtype': 'float32'}}
CROP, VIDEO = 'crop-icip-single', 'saliency-dhf1k-video'
MESH = 'crop-icip-mesh4'


def spec_with_video() -> dict:
    """BENCHMARK.json with the dynamic-saliency cell, whose files are in
    ``portbench/`` while the cell waits out of the benchmark (PERF.md)."""
    spec = json.loads((ROOT / 'BENCHMARK.json').read_text())
    spec['configs'].append({
        'name': 'unisal-dhf1k-dynamic',
        'file': 'portbench/configs/unisal-dhf1k-dynamic.json'})
    spec['workloads'].append({'name': VIDEO, 'config': 'unisal-dhf1k-dynamic',
                              'traffic': 'saliency_video', 'chips': 1})
    return spec


def small_run(workload, trace=False, config=None, control=False, seed=5):
    cfg = core.merged(SMALL_MODELS, config)
    return core.run(workload, seed, 0.01, trace, t_process=time.perf_counter(),
                    device='cpu', control=control, spec=spec_with_video(),
                    overrides={'traffic': SMALL, 'config': cfg})


@pytest.mark.parametrize('workload', [CROP, VIDEO,
                                      'crop-icip-retargetvid-q4'])
def test_program_equals_reference_in_float32(workload):
    res = small_run(workload, config=FLOAT32)
    assert res['correct'] is True
    assert res['attempted'] >= 1 and res['failed'] == 0
    for name, c in res['checks'].items():
        assert c['value'] == 0, name


@pytest.mark.parametrize('trace', [False, True])
def test_result_line_keys(trace):
    res = small_run(CROP, trace=trace)
    keys = ['correct', 'attempted', 'failed', 'metrics', 'device']
    assert list(res) == keys + (['breakdown'] if trace else []) + ['checks']
    assert set(res['device']) >= {'platform', 'kind', 'count',
                                  'memory_peak_bytes'}
    assert set(res['device']) >= {'busy_s', 'window_s'} or not trace
    spec = json.loads((ROOT / 'BENCHMARK.json').read_text())
    section = 'per_layer' if trace else 'end_to_end'
    allowed = set(core.metric_names(spec, CROP, section))
    assert set(res['metrics']) <= allowed
    if not trace:
        assert set(res['metrics']) == allowed


def _shift_boxes(monkeypatch):
    from retargetvid_tpu_torch.pipeline import fused
    inner = fused.geometry_boxes

    def altered(*args, **kwargs):
        out = inner(*args, **kwargs)
        out['boxes'] = out['boxes'] + 1
        return out
    monkeypatch.setattr(fused, 'geometry_boxes', altered)


def _alter_maps(monkeypatch):
    from retargetvid_tpu_torch.pipeline import saliency
    inner = saliency.saliency_postprocess

    def altered(logp):
        maps = inner(logp).clone()
        maps[:, : maps.shape[1] // 4] //= 2
        return maps
    monkeypatch.setattr(saliency, 'saliency_postprocess', altered)


@pytest.mark.parametrize('workload,fault', [(CROP, _shift_boxes),
                                            (VIDEO, _alter_maps)])
def test_an_answer_altered_where_it_is_produced_is_not_correct(
        workload, fault, monkeypatch):
    fault(monkeypatch)
    res = small_run(workload, config=FLOAT32)
    assert res['correct'] is False


@pytest.mark.parametrize('workload,number', [(CROP, 'map_gap_ratio'),
                                             (VIDEO, 'map_gap_ratio')])
def test_control_reads_farther_than_the_program(workload, number):
    res = small_run(workload, control=True)
    c = res['checks'][number]
    assert c['control'] > c['value']


def test_flops_equal_flop_counter_on_meta():
    tn = RefTransNet(f=2, d=16)
    x = ((1, 60, 27, 48, 3), torch.uint8)
    assert flops.layer_flops(lambda m, v: m(v), tn, x) == \
        flops.counter_flops(lambda m, v: m(v), tn, x)
    un = RefUNISAL(cnn_widen_factor=0.25)

    def static(m, v):
        return m(v, target_size=(70, 125), source='SALICON')

    def dynamic(m, v):
        return m(v, target_size=(72, 128), source='DHF1K', static=False)

    for fn, shape in ((static, (3, 1, 128, 224, 3)),
                      (dynamic, (1, 6, 128, 224, 3))):
        x = (shape, torch.float32)
        assert flops.layer_flops(fn, un, x) == \
            flops.counter_flops(fn, un, x)
    # The dynamic count is per chunk times the chunks of the clip.
    per_chunk = flops.layer_flops(dynamic, un, ((1, 6, 128, 224, 3),
                                                torch.float32))
    assert flops.unisal_dynamic(un, 48, (128, 224), (72, 128), 6, 4) == \
        8 * per_chunk


def test_bytes_by_hand():
    assert kbytes.postprocess_bytes(81, 140, 250) == 14_175_000
    assert kbytes.postprocess_bytes(480, 360, 640) == 552_960_000


def test_profile_counts_the_clips_of_the_traced_card():
    from portbench import trace
    out = trace.profile_clips(lambda: None, 3, torch.device('cpu'), 2)
    assert (out['dispatches'], out['clips']) == (3, 6)


def test_without_a_card_no_result(tmp_path):
    env = {**os.environ, 'CUDA_VISIBLE_DEVICES': ''}
    proc = subprocess.run(
        [sys.executable, 'portbench/run.py', '--workload', CROP, '--seed',
         '2147483999', '--seconds', '1', '--trace', '0'],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ''
    assert 'no CUDA device' in proc.stderr


def test_a_run_loads_no_jax():
    code = ('import sys, time; sys.path.insert(0, "."); '
            'from portbench import test_portbench_cpu as t, core; '
            't.small_run("%s"); t.small_run("%s"); '
            'print(core.forbidden_modules())' % (CROP, VIDEO))
    proc = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == '[]'


MESH_SMALL = {'frames': 48, 'height': 72, 'width': 128}


def mesh_small_run(fault=None, kill_rank=None, check_clips=2, control=False,
                   timed=False, flax_in_a_rank=None):
    """The four-rank cell at the small sizes, on the CPU over gloo: rank 0
    in this process, ranks 1-3 spawned.  Run it in a process of its own
    (:func:`mesh_subprocess`): it joins a process group, and a failing
    rank ends the process.  ``fault`` breaks rank 0's gather of the packed
    outputs after the exchange: ``'exchange'`` keeps only rank 0's own
    block (tiled over the batch), ``'order'`` reverses the ranks' blocks.
    ``kill_rank`` kills that rank at the second dispatch, mid-window.
    ``timed`` sets a ``StageTimer`` on rank 0 for the window, as a traced
    run on the card does, and adds ``timer`` to the result: each span's
    and counter's clip identifiers.  ``flax_in_a_rank``, a directory,
    makes the first spawned rank to start load a module named ``flax``."""
    import numpy as np
    from retargetvid_tpu_torch.parallel import runner
    gather = runner._gather_blocks

    def faulty(vecs, mesh):
        out = gather(vecs, mesh)
        k, dp = len(vecs), mesh.shape['dp']
        blocks = out.reshape(dp, k, -1)
        if fault == 'exchange':
            blocks = np.stack([blocks[mesh.dp_index]] * dp)
        elif fault == 'order':
            blocks = blocks[::-1]
        return blocks.reshape(dp * k, -1)
    if fault:
        runner._gather_blocks = faulty
    if kill_rank is not None:
        load = core.load_module

        def load_and_kill(kind, name):
            mod = load(kind, name)
            if kind == 'paths':
                dispatch, calls = mod.Adapter.dispatch, []

                def dispatch_and_kill(self, batch):
                    calls.append(1)
                    if len(calls) == 2:
                        pids = [p.pid for p in self.procs]
                        print('ranks', json.dumps(pids), file=sys.stderr,
                              flush=True)
                        os.kill(pids[kill_rank - 1], signal.SIGKILL)
                    return dispatch(self, batch)
                mod.Adapter.dispatch = dispatch_and_kill
            return mod
        core.load_module = load_and_kill
    timers = []
    if timed:
        from retargetvid_tpu_torch.utils.timing import StageTimer
        load_for_timer = core.load_module

        def load_and_time(kind, name):
            mod = load_for_timer(kind, name)
            if kind == 'paths':
                set_timer = mod.Adapter.set_timer

                def set_a_timer(self, timer):
                    if timer is None and not timers:
                        timers.append(StageTimer())
                        timer = timers[0]
                    set_timer(self, timer)
                mod.Adapter.set_timer = set_a_timer
            return mod
        core.load_module = load_and_time
    if flax_in_a_rank:
        # Read by every process spawned from here on, and by none started
        # before: rank 0 is already running.  Of those, the ranks carry
        # ``--multiprocessing-fork``; the first of them takes the marker.
        Path(flax_in_a_rank, 'sitecustomize.py').write_text(
            'import os, sys, types\n'
            "if '--multiprocessing-fork' in sys.argv:\n"
            '    try:\n'
            f'        os.close(os.open({str(Path(flax_in_a_rank, "taken"))!r},'
            ' os.O_CREAT | os.O_EXCL))\n'
            "        sys.modules['flax'] = types.ModuleType('flax')\n"
            '    except FileExistsError:\n'
            '        pass\n')
        os.environ['PYTHONPATH'] = os.pathsep.join(
            [str(flax_in_a_rank), str(ROOT)]
            + os.environ.get('PYTHONPATH', '').split(os.pathsep))
    res = core.run(MESH, 5, 0.01, False, t_process=time.perf_counter(),
                   device='cpu', control=control,
                   overrides={'traffic': {**MESH_SMALL,
                                          'check_clips': check_clips},
                              'config': core.merged(SMALL_MODELS, FLOAT32)})
    if timers:
        res['timer'] = {
            'spans': {n: sorted(r['clip'] for r in timers[0].spans()
                                if r['name'] == n)
                      for n in {r['name'] for r in timers[0].spans()}},
            'counts': {n: len(v) for n, v in timers[0].counts().items()}}
    return res


def mesh_subprocess(**kwargs):
    code = ('import json, sys; sys.path.insert(0, "."); '
            'from portbench import test_portbench_cpu as t; '
            'print(json.dumps(t.mesh_small_run(**%r)))' % (kwargs,))
    return subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)


def test_mesh_on_four_gloo_ranks_equals_reference():
    """Every clip of the batch checked: the gathered outputs come back in
    batch order, each equal to the reference's on its own clip; the
    control reads farther."""
    proc = mesh_subprocess(check_clips=8, control=True)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res['correct'] is True
    assert res['attempted'] >= 1 and res['failed'] == 0
    assert res['device']['count'] == 4
    for name, c in res['checks'].items():
        assert c['value'] == 0, name
    c = res['checks']['map_gap_ratio']
    assert c['control'] > c['value']
    # The control read clip by clip on one device, without the ranks, as
    # ``calibrate.py --control-only`` reads it on the card: the same
    # clips and weights give the same least reading.
    from portbench.paths import crop_mesh
    _, _, cfg, traffic = core.load_cell(MESH)
    every = crop_mesh.control_readings(
        core.merged(cfg, core.merged(SMALL_MODELS, FLOAT32)),
        core.merged(traffic, {**MESH_SMALL, 'check_clips': 2}), 5,
        torch.device('cpu'), every=True)
    assert sorted(every) == list(range(8))
    assert sum(r['checked'] for r in every.values()) == 2
    assert any(r['checked'] for c, r in every.items() if c >= 2)
    for name, c in res['checks'].items():
        assert min(r[name] for r in every.values()) == c['control'], name


def test_mesh_times_each_clip_of_rank_0():
    """A traced run's timer on the mesh: every clip rank 0 computes is one
    clip of the timer, with each stage once and each counter per clip."""
    proc = mesh_subprocess(timed=True)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    clips = list(range(2 * res['attempted']))   # 2 clips per dispatch
    spans = res['timer']['spans']
    for name in ('transnet', 'unisal', 'geometry'):
        assert spans[name] == clips, name
    assert res['timer']['counts']['dispatch_syncs'] == len(clips)


def test_mesh_rank_with_flax_loaded_gives_no_result(tmp_path):
    proc = mesh_subprocess(flax_in_a_rank=str(tmp_path))
    assert (tmp_path / 'taken').exists()
    assert proc.returncode == 2, proc.stderr[-3000:]
    assert proc.stdout.strip() == ''
    assert 'flax' in proc.stderr and 'without a result' in proc.stderr


@pytest.mark.parametrize('fault', ['exchange', 'order'])
def test_mesh_gather_fault_is_not_correct(fault):
    proc = mesh_subprocess(fault=fault)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res['correct'] is False


def test_mesh_killed_rank_ends_the_run_without_a_result():
    proc = mesh_subprocess(kill_rank=2)
    assert proc.returncode == 2, proc.stderr[-3000:]
    assert proc.stdout.strip() == ''
    assert 'without a result' in proc.stderr
    line = [x for x in proc.stderr.splitlines() if x.startswith('ranks ')]
    pids = json.loads(line[0][len('ranks '):])
    deadline = time.time() + 30
    for pid in pids:
        while True:
            try:
                os.kill(pid, 0)
            except ProcessLookupError:
                break
            assert time.time() < deadline, f'rank {pid} outlived the run'
            time.sleep(0.2)
