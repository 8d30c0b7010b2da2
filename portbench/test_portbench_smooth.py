"""CPU checks of the reader of the program's ``saliency_smooth`` counter:
it gives the median over the clips of a synthetic record, and a record
without the counter (a program without the smoothing-tail kernel) reads as
nothing.

    python -m pytest portbench -q
"""

import pytest

from portbench import core

#: Three clips, as ``StageTimer.times_ms`` gives them.
STAGES = {'transnet': [12.5, 13.0, 12.8], 'unisal': [21.0, 22.0, 21.5],
          'geometry': [20.0, 21.0, 20.5], 'bn_act': [64, 64, 64],
          'saliency_smooth': [1, 2, 1]}


def read(stages):
    rec = {'clip_ms': [], 'dispatch_ms': [], 'stages': stages, 'clips': 3,
           'window_s': 1.0, 'in_flight': 1}
    return core.load_module('metrics', 'smooth_per_clip').read(rec)


def test_reader_gives_the_median_over_clips():
    assert read(STAGES) == pytest.approx(1)


def test_parent_record_reads_nothing():
    parent = {k: v for k, v in STAGES.items() if k != 'saliency_smooth'}
    assert read(parent) is None
    assert read(dict(parent, saliency_smooth=[])) is None
