"""Timing: the stage-keyed wall-clock registry and the port's span and
counter recorder.

The registry is the port of ``retargetvid_tpu/utils/timing.py`` (reference
``smartVidCrop.py:98-127``): keys starting with ``_`` roll up into a
``total`` entry, and :func:`sc_all_times` reports every stage as
``"<sec>s, <percent-of-video-duration>%"`` -- the string contract that the
per-video ``_info.txt`` files and the evaluator parse.

:class:`StageTimer` is the port's one recorder of spans and counters.  A
program (``OneShotClipProgram``, ``FusedClipProgram``,
``SaliencyPredictor.predict_video``) makes its ``timer`` active for the
length of one call (:func:`active`); the code below it reaches the active
recorder through :func:`span` and :func:`count`, which do nothing when no
recorder is active.  Spans carry host timestamps from ``time.time_ns()``,
the clock the profiler stamps its events with, so a span can be laid over
a ``torch.profiler`` trace without adding anything to it.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Optional

import torch

__all__ = ["sc_init_time", "sc_register_time", "sc_save_time_override",
           "sc_all_times", "sc_get_time", "sc_times", "StageTimer",
           "active", "span", "count"]

_sc_times: dict[str, float] = {}


def sc_init_time() -> None:
    """Clear all registered timers (reference ``sc_init_time``)."""
    _sc_times.clear()


def sc_register_time(t_start: float, key_name: str) -> None:
    """Accumulate the seconds since ``t_start`` (a ``time.perf_counter()``
    timestamp) under ``key_name``."""
    add_t = time.perf_counter() - t_start
    _sc_times[key_name] = _sc_times.get(key_name, 0.0) + add_t


def sc_save_time_override(key_name: str, t: float) -> None:
    """Overwrite a timer with an absolute value (reference parity)."""
    _sc_times[key_name] = t


def sc_all_times(vid_dur: float) -> dict[str, str]:
    """Format all timers; keys starting '_' roll up into 'total'."""
    t_dict: dict[str, str] = {}
    sum_t = 0.0
    sum_p = 0.0
    for key_name, val in _sc_times.items():
        if key_name.startswith('_'):
            sum_t += val
            sum_p += (val / vid_dur) * 100.0
        t_dict[key_name] = '%7.3fs, %6.3f%%' % (val, (val / vid_dur) * 100.0)
    t_dict['total'] = '%7.3fs, %6.3f%%' % (sum_t, sum_p)
    return t_dict


def sc_get_time(key_name: str) -> float:
    return _sc_times[key_name]


def sc_times() -> dict[str, float]:
    """A copy of the raw timers (seconds), as the feature cache stores
    them."""
    return dict(_sc_times)


#: ``timer``: the recorder of the program call in progress on this thread,
#: if any.  The ops below a program have no handle to it; the program sets
#: it for the length of one call (:func:`active`).
_LOCAL = threading.local()
_NO_SPAN = contextlib.nullcontext()


class _Span:
    """One span being recorded; a context manager."""

    __slots__ = ('timer', 'name', 'id', 'parent', 'start_ns', 'start_ev')

    def __init__(self, timer: "StageTimer", name: str):
        self.timer = timer
        self.name = name

    def __enter__(self):
        t = self.timer
        self.id = t._n_spans
        t._n_spans += 1
        self.parent = t._stack[-1].id if t._stack else None
        t._stack.append(self)
        self.start_ns = time.time_ns()
        self.start_ev = t._event()
        return self

    def __exit__(self, *exc):
        t = self.timer
        end_ev = t._event()
        end_ns = time.time_ns()
        t._stack.pop()
        t._records.append((self.name, t._clip, self.id, self.parent,
                           self.start_ns, end_ns, self.start_ev, end_ev))
        return False


class StageTimer:
    """Spans and counters of a program's calls, kept in memory.

    Assign one to a program's ``timer``.  Every call of the program is one
    clip: it gets the next clip identifier, shared by every span and
    counter of that call.  A span (:func:`span`) records its name, the
    clip, its parent span, host start and end from ``time.time_ns()`` and,
    on a CUDA device, a pair of CUDA events for its device milliseconds
    (on the CPU the host duration).  A counter (:func:`count`) adds up per
    clip.  Neither adds a device sync; :meth:`spans` and :meth:`times_ms`
    synchronize once, when read after the run.

    Stages of the programs: ``transnet`` (with TransNet V2's
    ``transnet.stacks`` and ``transnet.similarity`` inside it),
    ``unisal``, ``geometry`` (with ``geometry.cluster``, ``geometry.redo``,
    ``geometry.interpolate``, ``geometry.lowpass`` and ``geometry.loess``
    inside it) and ``predict_video``'s ``chunks``.  Counters:
    ``transnet_frames``, ``ccl_sweeps``, ``redo_frames`` and
    ``dispatch_syncs``.
    """

    def __init__(self):
        self._records = []
        self._counts = {}
        self._stack = []
        self._clip = None
        self._n_clips = 0
        self._n_spans = 0
        self._stream = None

    def _event(self):
        if self._stream is None:
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(self._stream)
        return ev

    @contextlib.contextmanager
    def clip(self, device):
        """Make this recorder the active one of this thread for one
        program call on ``device``, under a new clip identifier (the one in progress when
        the recorder is active already)."""
        outer = getattr(_LOCAL, 'timer', None)
        if outer is self:
            yield self._clip
            return
        saved = self._clip, self._stream
        device = torch.device(device)
        self._clip = self._n_clips
        self._n_clips += 1
        self._stream = (torch.cuda.current_stream(device)
                        if device.type == 'cuda' else None)
        _LOCAL.timer = self
        try:
            yield self._clip
        finally:
            _LOCAL.timer = outer
            self._clip, self._stream = saved

    def span(self, name: str) -> _Span:
        return _Span(self, name)

    def count(self, name: str, n: int = 1) -> None:
        key = (self._clip, name)
        self._counts[key] = self._counts.get(key, 0) + n

    def spans(self) -> list:
        """Every closed span as a dict: ``name``, ``clip``, ``id``,
        ``parent`` (the enclosing span's ``id``, or None), ``start_ns``,
        ``end_ns`` (host, ``time.time_ns()``) and ``ms`` (device
        milliseconds from the CUDA events; the host's on the CPU)."""
        if any(r[6] is not None for r in self._records):
            torch.cuda.synchronize()
        return [{'name': name, 'clip': clip, 'id': i, 'parent': parent,
                 'start_ns': t0, 'end_ns': t1,
                 'ms': (e0.elapsed_time(e1) if e0 is not None
                        else (t1 - t0) * 1e-6)}
                for name, clip, i, parent, t0, t1, e0, e1 in self._records]

    def counts(self) -> dict:
        """``{name: [total per clip]}`` of the counters, clips in order."""
        out = {}
        for (_, name), n in self._counts.items():
            out.setdefault(name, []).append(n)
        return out

    def times_ms(self) -> dict:
        """``{name: [ms per occurrence]}`` of the spans, and each counter
        under its own name as one total per clip (:meth:`counts`); no
        counter has a span's name."""
        out = {}
        for r in self.spans():
            out.setdefault(r['name'], []).append(r['ms'])
        out.update(self.counts())
        return out


def active(timer: Optional[StageTimer], device):
    """The context of one program call: ``timer`` active on ``device``
    (nothing when ``timer`` is None)."""
    return _NO_SPAN if timer is None else timer.clip(device)


def span(name: str):
    """A span of the active recorder; a shared no-op context when none is
    active."""
    timer = getattr(_LOCAL, 'timer', None)
    return _NO_SPAN if timer is None else timer.span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the active recorder's counter ``name`` for the clip in
    progress; nothing when no recorder is active."""
    timer = getattr(_LOCAL, 'timer', None)
    if timer is not None:
        timer.count(name, n)
