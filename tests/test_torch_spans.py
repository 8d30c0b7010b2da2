"""The port's span and counter recorder (``utils/timing.py:StageTimer``)
over the one-shot program on the CPU: the spans of one dispatch and their
nesting, the geometry chain's counters against the clip's own tables,
outputs untouched by recording, nothing kept without a recorder, and the
spans' host clock against the profiler's.
"""

import threading

import numpy as np
import pytest
import torch

from test_torch_oneshot import H, W, clip_frames

torch.set_num_threads(1)

STAGES = ('transnet', 'unisal', 'geometry')
GEOMETRY_SPANS = ('geometry.cluster', 'geometry.redo',
                  'geometry.interpolate', 'geometry.lowpass',
                  'geometry.loess')
COUNTERS = ('transnet_frames', 'ccl_sweeps', 'redo_frames', 'dispatch_syncs')


class _CutAt(torch.nn.Module):
    """A TransNet stand-in whose transitions are the frames ``cuts``."""

    def __init__(self, cuts=()):
        super().__init__()
        self.cuts = list(cuts)

    def forward(self, frames):
        probs = torch.zeros((1, frames.shape[1]))
        probs[:, self.cuts] = 0.9
        return probs


@pytest.fixture(scope='module')
def setup():
    from conftest import TINY_UNISAL_CFG
    from retargetvid_tpu_torch.config import sc_init_crop_params
    from retargetvid_tpu_torch.models.init import seeded_init_
    from retargetvid_tpu_torch.models.unisal import UNISAL
    from retargetvid_tpu_torch.ops.boxes import calc_dest_size

    cp = sc_init_crop_params()
    cp['out_ratio'] = '1:3'
    dests = [calc_dest_size(W, H, r) for r in ('1:3', '3:1')]
    dests = [(d['w_final'], d['h_final']) for d in dests]
    un = seeded_init_(UNISAL(**TINY_UNISAL_CFG), 1)
    return cp, dests, un, clip_frames()


def program(un, cuts=()):
    from retargetvid_tpu_torch.pipeline.oneshot import OneShotClipProgram
    return OneShotClipProgram(_CutAt(cuts), un, dtype=torch.float32,
                              tn_fullseq=True, device='cpu')


def run_one(prog, frames, cp, dest):
    return prog.collect(prog.dispatch(frames, cp, fps=30.0,
                                      w_final=dest[0], h_final=dest[1]))


def expected_redo_frames(out, s_pad=8):
    """The cut-boundary redo count from the clip's picks and scenes: a
    cut at each scene's first pick and at the last pick; frame i+1 is
    redone when i < fc_sel - 2 and a cut lies in {i-1, i, i+1}."""
    fc_sel, n_seg = out['fc_sel'], out['n_segments']
    picks = np.asarray(out['sel_idx'][:fc_sel], np.int64)
    starts = np.asarray(out['seg_starts'][:n_seg], np.int64)
    cuts = {int(np.searchsorted(picks, s, side='right')) - 1
            for s in starts} | {fc_sel - 1}
    redo = [i + 1 for i in range(fc_sel - 2)
            if cuts & {i - 1, i, i + 1}]
    t_sel_pad = len(out['sel_idx'])
    return min(len(redo), 3 * (s_pad + 2), t_sel_pad)


@pytest.mark.parametrize('cuts', [(), (24,)], ids=['one_shot', 'two_shots'])
def test_dispatch_records_the_spans_and_counters(setup, cuts):
    from retargetvid_tpu_torch.utils.timing import StageTimer

    cp, dests, un, frames = setup
    prog = program(un, cuts)
    prog.timer = timer = StageTimer()
    out = run_one(prog, frames, cp, dests[0])
    spans = timer.spans()
    names = [s['name'] for s in spans]
    assert sorted(names) == sorted(STAGES + GEOMETRY_SPANS)
    assert {s['clip'] for s in spans} == {0}
    by_name = {s['name']: s for s in spans}
    for name in STAGES:
        assert by_name[name]['parent'] is None
    geo = by_name['geometry']
    for name in GEOMETRY_SPANS:
        s = by_name[name]
        assert s['parent'] == geo['id'], name
        assert geo['start_ns'] <= s['start_ns'] <= s['end_ns'] \
            <= geo['end_ns'], name
    for s in spans:
        assert s['ms'] == pytest.approx((s['end_ns'] - s['start_ns']) * 1e-6)

    counts = timer.counts()
    assert set(counts) == set(COUNTERS)
    assert all(len(v) == 1 for v in counts.values())
    # The full-sequence plan: the clip and 25 edge frames on each side.
    assert counts['transnet_frames'] == [len(frames) + 50]
    redo = counts['redo_frames'][0]
    assert redo == expected_redo_frames(out) > 0
    # One connected-components pass per clustering call: pass 1 and one
    # per redo frame, each of 1 to cc_iters sweeps.
    calls = 1 + redo
    assert calls <= counts['ccl_sweeps'][0] <= 12 * calls
    assert counts['dispatch_syncs'][0] > counts['ccl_sweeps'][0]

    times = timer.times_ms()
    assert set(times) == set(STAGES + GEOMETRY_SPANS + COUNTERS)
    assert times['redo_frames'] == [redo]


def test_clips_get_their_own_identifier(setup):
    from retargetvid_tpu_torch.utils.timing import StageTimer

    cp, dests, un, frames = setup
    prog = program(un)
    prog.timer = timer = StageTimer()
    run_one(prog, frames, cp, dests[0])
    run_one(prog, frames, cp, dests[0])
    spans = timer.spans()
    assert sorted({s['clip'] for s in spans}) == [0, 1]
    assert sum(s['clip'] == 1 for s in spans) == len(spans) // 2
    counts = timer.counts()
    # The same clip twice: the same counts, one total per clip.
    assert all(len(v) == 2 and v[0] == v[1] for v in counts.values())
    assert len(timer.times_ms()['geometry']) == 2


@pytest.mark.parametrize('multi', [False, True], ids=['dispatch',
                                                      'dispatch_multi'])
def test_outputs_are_the_same_recorded_or_not(setup, multi):
    from retargetvid_tpu_torch.utils.timing import StageTimer

    cp, dests, un, frames = setup
    prog = program(un, (24,))
    outs = []
    for timer in (None, StageTimer()):
        prog.timer = timer
        if multi:
            outs.append(prog.collect_multi(prog.dispatch_multi(
                frames, cp, fps=30.0, dests=dests)))
        else:
            outs.append([run_one(prog, frames, cp, dests[0])])
    assert len(prog.timer.times_ms()['geometry']) == 1
    for off, on in zip(*outs):
        assert set(off) == set(on)
        for k in off:
            assert np.array_equal(np.asarray(off[k]), np.asarray(on[k])), k


def test_nothing_is_kept_without_a_recorder(setup, monkeypatch):
    from retargetvid_tpu_torch.utils import timing

    cp, dests, un, frames = setup
    calls = []
    monkeypatch.setattr(timing.StageTimer, 'span',
                        lambda self, name: calls.append(name))
    monkeypatch.setattr(timing.StageTimer, 'count',
                        lambda self, name, n=1: calls.append(name))
    prog = program(un)
    for _ in range(2):
        run_one(prog, frames, cp, dests[0])
    assert calls == []
    assert getattr(timing._LOCAL, 'timer', None) is None
    assert timing.span('geometry') is timing.span('transnet')
    assert timing.count('dispatch_syncs') is None


def test_span_shares_the_profilers_clock():
    """A span's ``time.time_ns()`` interval brackets the profiler's event
    of the one op inside it: kineto stamps the Unix clock."""
    from torch.profiler import ProfilerActivity, profile

    from retargetvid_tpu_torch.utils import timing

    x = torch.randn(4096)
    timer = timing.StageTimer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timer.clip('cpu'), timing.span('op'):
            x * 3.0
    (s,) = timer.spans()
    events = [ev for ev in prof.profiler.kineto_results.events()
              if ev.name() == 'aten::mul']
    assert len(events) == 1
    ev = events[0]
    assert s['start_ns'] <= ev.start_ns()
    assert ev.start_ns() + ev.duration_ns() <= s['end_ns']


def test_nested_activation_keeps_the_clip():
    from retargetvid_tpu_torch.utils import timing

    timer = timing.StageTimer()
    with timing.active(timer, 'cpu'):
        with timing.active(timer, 'cpu'), timing.span('inner'):
            timing.count('redo_frames', 2)
        timing.count('redo_frames', 3)
    with timing.active(timer, 'cpu'):
        timing.count('redo_frames', 0)
    assert getattr(timing._LOCAL, 'timer', None) is None
    assert [s['clip'] for s in timer.spans()] == [0]
    assert timer.counts() == {'redo_frames': [5, 0]}


def test_recorder_is_active_on_its_own_thread_only():
    """Work on another thread (a decoder, say) during a recorded call
    adds nothing to the clip."""
    from retargetvid_tpu_torch.utils import timing

    timer = timing.StageTimer()

    def other():
        with timing.span('geometry'):
            timing.count('dispatch_syncs', 7)

    with timing.active(timer, 'cpu'):
        worker = threading.Thread(target=other)
        worker.start()
        worker.join(timeout=30)
        timing.count('dispatch_syncs')
    assert not worker.is_alive()
    assert timer.spans() == []
    assert timer.counts() == {'dispatch_syncs': [1]}
