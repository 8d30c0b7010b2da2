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
