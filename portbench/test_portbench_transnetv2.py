"""CPU runs of ``crop-transnetv2-single`` at a small size: the program
against the reference, the faults that must come out as not correct, the
control, the window plan's FLOP count, the cell's readers, and a program
without TransNet V2.

TransNet V2 is cut in width here (F=2, D=16), UNISAL's backbone to 0.25
and the clips to 48 frames of 72x128; the benchmark runs the
configuration's widths on the card.

    python -m pytest portbench -q
"""

import sys
import time

import pytest
import torch

from portbench import core
from portbench.counts import transnetv2 as v2_flops
from portbench.reference.transnetv2 import TransNetV2 as RefTransNetV2
from portbench.test_portbench_cpu import FLOAT32, SMALL, SMALL_MODELS

torch.set_num_threads(2)
CELL = 'crop-transnetv2-single'
#: Float32 everywhere: the program's window batch against the reference's
#: one window a forward moves a float32 logit by about 1e-7 (the order of
#: a reduction), against a bf16 gap of about 1e-3: a ratio of about 1e-4.
FLOAT32_RATIO = 1e-3


def small_run(config=None, control=False, trace=False, seed=2147483901):
    return core.run(CELL, seed, 0.01, trace, t_process=time.perf_counter(),
                    device='cpu', control=control,
                    overrides={'traffic': SMALL,
                               'config': core.merged(SMALL_MODELS, config)})


def test_program_equals_reference_in_float32():
    res = small_run(config=FLOAT32)
    assert res['correct'] is True
    assert res['attempted'] >= 1 and res['failed'] == 0
    checks = res['checks']
    assert set(checks) == {'scene_mismatch', 'map_gap_ratio',
                           'geometry_mismatch', 'shot_logit_gap_ratio'}
    for name in ('scene_mismatch', 'map_gap_ratio', 'geometry_mismatch'):
        assert checks[name]['value'] == 0, name
    assert checks['shot_logit_gap_ratio']['value'] <= FLOAT32_RATIO


def _zero_histograms(monkeypatch):
    from retargetvid_tpu_torch.models import transnetv2
    monkeypatch.setattr(transnetv2.ColorHistograms, 'histograms',
                        staticmethod(lambda frames: torch.zeros(
                            (*frames.shape[:2], 512), device=frames.device)))


def _shift_band(monkeypatch):
    """Row t's band read one frame late: entries t - 49 .. t + 51."""
    from retargetvid_tpu_torch.models import transnetv2
    band = transnetv2._band
    monkeypatch.setattr(transnetv2, '_band',
                        lambda sim, lookup: band(sim, lookup + 2)[..., 2:])


@pytest.mark.parametrize('fault', [_zero_histograms, _shift_band],
                         ids=['histograms_zeroed', 'band_shifted'])
def test_a_fault_in_the_shot_detector_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    res = small_run(config=FLOAT32)
    assert res['correct'] is False
    c = res['checks']['shot_logit_gap_ratio']
    assert c['value'] > c['limit']


def test_control_reads_farther_than_the_program():
    res = small_run(control=True)
    c = res['checks']['shot_logit_gap_ratio']
    assert c['control'] > c['value']


@pytest.mark.parametrize('widths', [{}, {'F': 2, 'D': 16}],
                         ids=['published', 'narrow'])
def test_window_plan_count_equals_flop_counter_on_meta(widths):
    tn = RefTransNetV2(**widths)
    assert v2_flops.windows(480) == 11 and v2_flops.windows(48) == 2
    for frames in (48, 480):
        total = v2_flops.window_plan(tn, frames)
        assert total == v2_flops.window_plan_counter(tn, frames)
        assert v2_flops.histogram_bmm(frames) < v2_flops.stacks(tn, frames) \
            < total
    if not widths:
        # 915.19 GFLOP a 480-frame clip, 903.91 of them in the stacks.
        assert v2_flops.window_plan(tn, 480) == 915_194_931_200
        assert v2_flops.stacks(tn, 480) == 903_908_966_400


STAGES = {'transnet': [30.0, 32.0], 'transnet.stacks': [20.0, 24.0],
          'transnet.similarity': [1.0, 2.0], 'transnet_frames': [1100, 1100]}


def record(stages, **extra):
    return {'clip_ms': [], 'dispatch_ms': [], 'stages': stages, 'clips': 2,
            'window_s': 1.0, 'in_flight': 1, **extra}


def test_readers_of_the_cell():
    def read(metric, rec):
        return core.load_module('metrics', metric).read(rec)

    rec = record(STAGES, transnet_stack_flops=[(989e9, 'bfloat16')])
    assert read('tnv2_stacks_ms', rec) == 22.0
    assert read('tnv2_similarity_ms', rec) == 1.5
    assert read('transnet_frames_per_clip', rec) == 1100
    # 1 ms at bf16's peak over a median of 22 ms.
    assert read('tnv2_stacks_roofline', rec) == pytest.approx(100 / 22)
    # A program without V2's spans, or a run without the count.
    parent = record({'transnet': [12.5, 13.0]})
    for metric in ('tnv2_stacks_ms', 'tnv2_similarity_ms',
                   'transnet_frames_per_clip', 'tnv2_stacks_roofline'):
        assert read(metric, parent) is None, metric
    assert read('tnv2_stacks_roofline', record(STAGES)) is None


def test_a_program_without_transnetv2_gives_no_result(monkeypatch):
    monkeypatch.setitem(sys.modules,
                        'retargetvid_tpu_torch.models.transnetv2', None)
    with pytest.raises(core.NoResult, match='no TransNet V2'):
        small_run()
