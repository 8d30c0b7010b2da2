"""CPU checks of BENCHMARK.json and the harness's files: every cell and
metric resolves to its files, the names and limits keep the contract, and
no file of the benchmark imports JAX or the JAX package.

    python -m pytest portbench -q
"""

import ast
import json
import re
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
SPEC = json.loads((ROOT / 'BENCHMARK.json').read_text())
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
FORBIDDEN = {'jax', 'jaxlib', 'flax', 'retargetvid_tpu'}


def imported_top_levels(path: Path) -> set:
    """Top-level names of every module a file imports, whole."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split('.')[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            out.add(node.module.split('.')[0])
    return out


def test_top_level_keys_and_command():
    assert list(SPEC) == ['command', 'paths', 'run_seconds', 'configs',
                          'workloads', 'end_to_end', 'per_layer']
    assert SPEC['paths'] == ['portbench']
    assert SPEC['command'][1] == 'portbench/run.py'
    assert (ROOT / SPEC['command'][1]).is_file()
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_run_seconds_fit_a_full_check():
    rs = SPEC['run_seconds']
    assert 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize('conf', SPEC['configs'], ids=lambda c: c['name'])
def test_config_resolves(conf):
    assert set(conf) == {'name', 'source', 'file', 'reduced', 'why'}
    assert NAME.match(conf['name'])
    path = ROOT / conf['file']
    assert path.is_file() and conf['file'].startswith('portbench/')
    data = json.loads(path.read_text())
    assert data['name'] == conf['name']
    assert data['source'] == conf['source']
    assert data['reduced'] == conf['reduced'] == []
    assert data['limits'], 'every configuration states its limits'
    assert any(w['config'] == conf['name'] for w in SPEC['workloads'])


@pytest.mark.parametrize('cell', SPEC['workloads'], ids=lambda w: w['name'])
def test_cell_resolves(cell):
    assert set(cell) == {'name', 'config', 'traffic', 'chips', 'why'}
    assert NAME.match(cell['name']) and NAME.match(cell['traffic'])
    assert cell['chips'] in (1, 4)
    assert 1 <= len(cell['why']) <= 200 and '\n' not in cell['why']
    traffic = json.loads((HERE / 'traffic' / f'{cell["traffic"]}.json')
                         .read_text())
    assert (HERE / 'paths' / f'{traffic["path"]}.py').is_file()
    for key in ('frames', 'height', 'width', 'check_clips', 'in_flight'):
        assert int(traffic[key]) > 0
    if 'dp' in traffic:
        # Ranks, one per card: the batch is dp x clips_per_rank clips.
        assert int(traffic['dp']) == cell['chips'] and 'pool' not in traffic
        assert int(traffic['clips_per_rank']) > 0
    else:
        assert cell['chips'] == 1 and int(traffic['pool']) > 0
    e2e = [m['name'] for m in SPEC['end_to_end']
           if cell['name'] in m.get('workloads', [cell['name']])]
    assert 'setup_s' in e2e and len(e2e) >= 2
    layer = [m for m in SPEC['per_layer']
             if cell['name'] in m.get('workloads', [cell['name']])]
    assert layer and all(m['moves'] in e2e for m in layer)


def test_four_chip_cells_are_capped():
    four = [w['name'] for w in SPEC['workloads'] if w['chips'] == 4]
    assert len(four) <= max(1, len(SPEC['workloads']) // 4), four


def test_pairs_and_names_are_unique():
    pairs = [(w['config'], w['traffic']) for w in SPEC['workloads']]
    assert len(set(pairs)) == len(pairs)
    names = [m['name'] for m in SPEC['end_to_end'] + SPEC['per_layer']]
    assert len(set(names)) == len(names)


@pytest.mark.parametrize('metric', SPEC['end_to_end'],
                         ids=lambda m: m['name'])
def test_end_to_end_metric(metric):
    from portbench import core
    assert set(metric) <= {'name', 'unit', 'better', 'bound', 'source',
                           'workloads'}
    assert NAME.match(metric['name']) and UNIT.match(metric['unit'])
    assert metric['source'] == 'host_clock'
    assert 0.01 <= metric['bound'] <= 0.25
    rec = {'frames': 960, 'window_s': 2.0, 'clip_ms': [900.0, 1100.0]}
    assert core.end_to_end(metric['name'], rec, 12.5) > 0


@pytest.mark.parametrize('metric', SPEC['per_layer'], ids=lambda m: m['name'])
def test_per_layer_metric_has_a_reader(metric):
    from portbench import core
    assert set(metric) <= {'name', 'unit', 'better', 'source', 'layer',
                           'moves', 'workloads'}
    assert NAME.match(metric['name']) and UNIT.match(metric['unit'])
    assert metric['moves'] in {m['name'] for m in SPEC['end_to_end']}
    cells = {w['name'] for w in SPEC['workloads']}
    assert set(metric.get('workloads', cells)) <= cells
    reader = core.load_module('metrics', metric['name'])
    empty = {'clip_ms': [], 'dispatch_ms': [], 'stages': {}, 'clips': 0,
             'window_s': 1.0, 'in_flight': 1}
    assert reader.read(empty) is None          # nothing to read: no value


def test_readers_read_a_record():
    from portbench import core
    rec = {'clip_ms': [500.0, 700.0, 600.0], 'dispatch_ms': [480.0, 520.0],
           'stages': {'geometry': [400.0, 420.0, 440.0],
                      'transnet': [13.0], 'unisal': [38.0],
                      'chunks': [1200.0]},
           'clips': 3, 'window_s': 1.8, 'in_flight': 4,
           'model_flops': [(989e9, 'bfloat16'), (495e9, 'tf32')],
           'postprocess_bytes': 3350000,
           'profile': {'busy_s': 0.3, 'window_s': 1.5, 'clips': 3,
                       'launches': 3000,
                       'kernels': {'void saliency_postprocess_kernel<true>'
                                   '(float const*)': (3e-5, 3)}}}
    got = {m: core.load_module('metrics', m).read(rec) for m in (
        'geometry_ms', 'dispatch_ms', 'queue_clip_ms_p50', 'device_idle',
        'launches_per_clip', 'postprocess_roofline', 'mfu')}
    assert got['geometry_ms'] == 420.0
    assert got['dispatch_ms'] == 500.0
    assert got['queue_clip_ms_p50'] == 600.0
    assert got['device_idle'] == pytest.approx(80.0)
    assert got['launches_per_clip'] == 1000
    # 3.35 MB at 3.35 TB/s is 1 us, against 10 us of kernel per clip.
    assert got['postprocess_roofline'] == pytest.approx(10.0)
    # 2 ms at the peaks against 0.6 s per clip.
    assert got['mfu'] == pytest.approx(100 * 2e-3 / 0.6)


def test_gather_ms_reads_nccl_kernels_per_dispatch():
    from portbench import core
    reader = core.load_module('metrics', 'gather_ms')
    kernels = {'ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage'
               '<4096ul>)': (3e-4, 6),
               'void saliency_postprocess_kernel<true>(float const*)':
               (6e-5, 6)}
    # Three dispatches of two clips each on the traced card.
    rec = {'profile': {'kernels': kernels, 'clips': 6, 'dispatches': 3}}
    assert reader.read(rec) == pytest.approx(0.1)
    rec['profile']['kernels'] = {k: v for k, v in kernels.items()
                                 if 'nccl' not in k}
    assert reader.read(rec) is None


def test_layers_are_named_alike():
    for m in SPEC['per_layer']:
        assert 1 <= len(m['layer']) <= 200 and '\n' not in m['layer']


def test_no_file_imports_jax_or_the_jax_package():
    for path in HERE.rglob('*.py'):
        assert not imported_top_levels(path) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_program():
    for path in (HERE / 'reference').rglob('*.py'):
        tops = imported_top_levels(path)
        assert not tops & (FORBIDDEN | {'retargetvid_tpu_torch'}), path
