"""Stage-keyed wall-clock timing registry.

Port of ``retargetvid_tpu/utils/timing.py`` (reference
``smartVidCrop.py:98-127``): keys starting with ``_`` roll up into a
``total`` entry, and :func:`sc_all_times` reports every stage as
``"<sec>s, <percent-of-video-duration>%"`` -- the string contract that the
per-video ``_info.txt`` files and the evaluator parse.

CUDA work is asynchronous; :func:`stage_timer` synchronizes the device it
is given before it closes the timer.
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator, Optional

import torch

__all__ = ["sc_init_time", "sc_register_time", "sc_save_time_override",
           "sc_all_times", "sc_get_time", "sc_times", "stage_timer"]

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


@contextlib.contextmanager
def stage_timer(key_name: str,
                device: Optional[torch.device] = None) -> Iterator[None]:
    """Time a stage; with a CUDA ``device``, synchronize it first."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if device is not None and torch.device(device).type == 'cuda':
            torch.cuda.synchronize(device)
        sc_register_time(t0, key_name)
