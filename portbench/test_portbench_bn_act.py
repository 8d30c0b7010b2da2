"""CPU checks of the reader of the program's ``bn_act`` counter: it gives
the median over the clips of a synthetic record, and a record without the
counter (a program without the BatchNorm epilogue kernel) reads as
nothing.

    python -m pytest portbench -q
"""

import pytest

from portbench import core

#: Two clips, as ``StageTimer.times_ms`` gives them.
STAGES = {'transnet': [12.5, 13.0], 'unisal': [31.0, 32.0],
          'geometry': [20.0, 21.0], 'bn_act': [62, 66]}


def read(stages):
    rec = {'clip_ms': [], 'dispatch_ms': [], 'stages': stages, 'clips': 2,
           'window_s': 1.0, 'in_flight': 1}
    return core.load_module('metrics', 'bn_act_per_clip').read(rec)


def test_reader_gives_the_median_over_clips():
    assert read(STAGES) == pytest.approx(64)


def test_parent_record_reads_nothing():
    parent = {k: v for k, v in STAGES.items() if k != 'bn_act'}
    assert read(parent) is None
    assert read(dict(parent, bn_act=[])) is None
