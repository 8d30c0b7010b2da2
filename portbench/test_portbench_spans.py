"""CPU checks of the readers of the geometry chain's spans and the
program's counters: each gives the median over the clips of a synthetic
record, ``geometry_self_ms`` subtracts the children clip by clip, and a
record without them (a program that has no such span or counter) reads
as nothing.

    python -m pytest portbench -q
"""

import pytest

from portbench import core

SPANS = {'cluster_ms': 'geometry.cluster', 'redo_ms': 'geometry.redo',
         'interpolate_ms': 'geometry.interpolate',
         'lowpass_ms': 'geometry.lowpass', 'loess_ms': 'geometry.loess'}
COUNTERS = {'ccl_sweeps_per_clip': 'ccl_sweeps',
            'redo_frames_per_clip': 'redo_frames',
            'dispatch_syncs_per_clip': 'dispatch_syncs'}
#: Two clips, as ``StageTimer.times_ms`` gives them.
STAGES = {'transnet': [12.5, 13.0], 'unisal': [37.0, 38.0],
          'geometry': [460.0, 500.0],
          'geometry.cluster': [8.0, 10.0], 'geometry.redo': [4.0, 6.0],
          'geometry.interpolate': [2.0, 3.0],
          'geometry.lowpass': [420.0, 440.0], 'geometry.loess': [1.0, 2.0],
          'ccl_sweeps': [6, 8], 'redo_frames': [2, 2],
          'dispatch_syncs': [52, 54]}


def record(stages):
    return {'clip_ms': [], 'dispatch_ms': [], 'stages': stages, 'clips': 2,
            'window_s': 1.0, 'in_flight': 1}


def read(metric, stages):
    return core.load_module('metrics', metric).read(record(stages))


@pytest.mark.parametrize('metric', sorted({**SPANS, **COUNTERS}))
def test_reader_gives_the_median_over_clips(metric):
    key = {**SPANS, **COUNTERS}[metric]
    lo, hi = STAGES[key]
    assert read(metric, STAGES) == pytest.approx((lo + hi) / 2)
    assert read(metric, {k: v for k, v in STAGES.items() if k != key}) \
        is None


def test_geometry_self_is_geometry_less_its_children_per_clip():
    # Clip 1: 460 - (8 + 4 + 2 + 420 + 1) = 25; clip 2: 500 - 461 = 39.
    assert read('geometry_self_ms', STAGES) == pytest.approx(32.0)
    # Per clip, not from the medians: a third clip changes every median.
    three = {k: v + [v[0]] for k, v in STAGES.items()}
    three['geometry'][2] = 1000.0
    three['geometry.lowpass'][2] = 900.0
    # 1000 - (8 + 4 + 2 + 900 + 1) = 85; the median of 25, 39, 85.
    assert read('geometry_self_ms', three) == pytest.approx(39.0)


@pytest.mark.parametrize('missing', ['geometry'] + list(SPANS.values()))
def test_geometry_self_needs_every_span(missing):
    stages = {k: v for k, v in STAGES.items() if k != missing}
    assert read('geometry_self_ms', stages) is None
    uneven = dict(STAGES, **{missing: STAGES[missing][:1]})
    assert read('geometry_self_ms', uneven) is None


def test_parent_record_reads_nothing():
    """The stages a program without these spans and counters records."""
    parent = {k: STAGES[k] for k in ('transnet', 'unisal', 'geometry')}
    parent['postprocess'] = [0.02, 0.02]
    for metric in ['geometry_self_ms', *SPANS, *COUNTERS]:
        assert read(metric, parent) is None
