"""Butterworth SOS filtfilt: (B, L) padded series -> the low-passed series.

scipy's ``filtfilt`` over second-order sections (from
``ops/filters.py:_butter_design``) with its odd-extension padding and
``sosfilt_zi`` initial states, per row of a (B, L) float32 batch with live
lengths ``n`` (B,): the whole (B, L) result, the padded tail included.  On
a CUDA tensor :func:`butter_filtfilt` launches the hand-written kernel
``csrc/butter_filtfilt.cu`` once, with the plan of :func:`launch_plan` and
the design packed by :func:`pack_design`; on a CPU tensor it runs the plain
PyTorch version :func:`butter_filtfilt_reference`, whose Python loop over
time the kernel replaces (it replaces no TPU kernel: the JAX package runs
this recurrence as an XLA ``scan``).  Any other input raises.  The kernel is
bit-equal to the plain version.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from retargetvid_tpu_torch.kernels.build import launch
from retargetvid_tpu_torch.utils import timing

__all__ = ["butter_filtfilt", "butter_filtfilt_reference", "pack_design",
           "launch_plan", "LaunchPlan", "Design", "Section", "MAX_SECTIONS"]

#: Rows per CTA at most and sections a design may have; kept in step with
#: ``kMaxRows`` and ``kMaxSections`` in the CUDA source.
MAX_ROWS = 32
MAX_SECTIONS = 8
#: Shared memory a block may use on an H100, less the kernel's static
#: ``live_n`` array.
SMEM_LIMIT = 232448 - 4 * MAX_ROWS


class Section(ctypes.Structure):
    """One second-order section: ``y = b0 x + s0``, ``s' = M s + v x``,
    initial state ``zi * x[0]``."""
    _fields_ = [(name, ctypes.c_float) for name in
                ('b0', 'm00', 'm01', 'm10', 'm11', 'v0', 'v1', 'zi0', 'zi1')]


class Design(ctypes.Structure):
    """The kernel's design argument, passed by value at launch."""
    _fields_ = [('n_sections', ctypes.c_int), ('padlen', ctypes.c_int),
                ('sec', Section * MAX_SECTIONS)]


def pack_design(padlen: int, sections) -> Design:
    """``_butter_design``'s ``(padlen, sections)`` as the kernel's argument;
    raises for more than :data:`MAX_SECTIONS` sections."""
    if not 1 <= len(sections) <= MAX_SECTIONS:
        raise ValueError(f'butter_filtfilt takes 1 to {MAX_SECTIONS} '
                         f'second-order sections, got {len(sections)}')
    design = Design(n_sections=len(sections), padlen=int(padlen))
    for k, (b0, m, v, zi) in enumerate(sections):
        design.sec[k] = Section(b0, m[0][0], m[0][1], m[1][0], m[1][1],
                                v[0], v[1], zi[0], zi[1])
    return design


class LaunchPlan(NamedTuple):
    """How the kernel covers a (B, L) batch: ``rows`` rows per CTA, each
    with ``row_floats`` floats of work area, in shared memory
    (``smem_bytes`` per CTA) or, where one row does not fit, in a device
    scratch buffer."""
    rows: int
    ctas: int
    row_floats: int
    shared: bool
    smem_bytes: int


def launch_plan(b: int, l: int, padlen: int) -> LaunchPlan:
    """The kernel's plan for ``b`` rows of ``l`` samples: up to
    :data:`MAX_ROWS` rows per CTA, fewer where their areas (2N + 1 floats
    each, N = l + 2 padlen) would overflow shared memory, spread evenly
    over the CTAs."""
    row_floats = 2 * (l + 2 * padlen) + 1
    fit = SMEM_LIMIT // (4 * row_floats)
    shared = fit >= 1
    cap = min(MAX_ROWS, fit) if shared else MAX_ROWS
    ctas = max(1, -(-b // cap))
    rows = -(-b // ctas)
    return LaunchPlan(rows=rows, ctas=ctas, row_floats=row_floats,
                      shared=shared,
                      smem_bytes=4 * rows * row_floats if shared else 0)


def _cascade(sig: torch.Tensor, mask: torch.Tensor, sections) -> torch.Tensor:
    """SOS cascade over (B, N) signals; masked-out steps pass the input
    through and keep the state.  Every section's initial state scales by
    the cascade's first input sample (scipy ``sosfilt`` with ``zi``).

    The sections run in one sequential loop over time: section k's output
    at step n is section k+1's input at step n, the same arithmetic as
    filtering the whole signal section by section.
    """
    x0 = sig[:, 0]
    states = [(zi[0] * x0, zi[1] * x0) for _, _, _, zi in sections]
    ys = []
    for n in range(sig.shape[1]):
        y = sig[:, n]
        mt = mask[:, n]
        for k, (b0, m, v, _) in enumerate(sections):
            s0, s1 = states[k]
            xt = y
            y = torch.where(mt, b0 * xt + s0, xt)
            n0 = (m[0][0] * s0 + m[0][1] * s1) + v[0] * xt
            n1 = (m[1][0] * s0 + m[1][1] * s1) + v[1] * xt
            states[k] = (torch.where(mt, n0, s0), torch.where(mt, n1, s1))
        ys.append(y)
    return torch.stack(ys, dim=1)


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(x, 1, idx)


def butter_filtfilt_reference(x: torch.Tensor, n: torch.Tensor, padlen: int,
                              sections) -> torch.Tensor:
    """Plain PyTorch version: the odd extension, the forward cascade, the
    reversal, the backward cascade, the reversal back and the crop."""
    b, L = x.shape
    dev = x.device
    idx = torch.arange(L + 2 * padlen, device=dev)[None, :].expand(b, -1)
    nn_ = n.to(torch.int64)[:, None]
    xe = _gather(x, torch.clamp(nn_ - 1, 0, L - 1))
    x0 = x[:, :1]

    # Odd extension: [0, padlen) left, [padlen, padlen+n) data,
    # [padlen+n, 2*padlen+n) right.
    left = 2.0 * x0 - _gather(x, torch.clamp(padlen - idx, 0, L - 1))
    mid = _gather(x, torch.clamp(idx - padlen, 0, L - 1))
    jr = idx - padlen - nn_
    right = 2.0 * xe - _gather(x, torch.clamp(nn_ - 2 - jr, 0, L - 1))
    zero = torch.zeros_like(mid)
    ext = torch.where(idx < padlen, left, torch.where(
        idx < padlen + nn_, mid, torch.where(idx < 2 * padlen + nn_,
                                             right, zero)))
    ext_mask = idx < 2 * padlen + nn_

    y1 = _cascade(ext, ext_mask, sections)
    # Backward pass over the live region reversed into the front.
    rev_idx = torch.clamp(2 * padlen + nn_ - 1 - idx, 0, L + 2 * padlen - 1)
    y1r = _gather(y1, rev_idx)
    y2 = _cascade(y1r, ext_mask, sections)
    return _gather(y2, rev_idx)[:, padlen:padlen + L]


#: The library's C functions, typed once when it is loaded.
_SIGNATURES = {
    'rtv_butter_filtfilt': (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
        + [ctypes.POINTER(Design), ctypes.c_void_p], ctypes.c_int),
}


def _launch(x: torch.Tensor, n: torch.Tensor, padlen: int,
            sections) -> torch.Tensor:
    if x.dtype != torch.float32:
        raise TypeError(f'butter_filtfilt takes float32, got {x.dtype}')
    if x.ndim != 2:
        raise ValueError(f'butter_filtfilt takes (B, L), got '
                         f'{tuple(x.shape)}')
    if not x.is_contiguous():
        raise ValueError('butter_filtfilt takes a contiguous tensor')
    b, l = x.shape
    if n.shape != (b,) or n.device != x.device or n.is_floating_point():
        raise ValueError(f'butter_filtfilt takes integer lengths ({b},) on '
                         f'{x.device}, got {n.dtype} {tuple(n.shape)} on '
                         f'{n.device}')
    design = pack_design(padlen, sections)
    out = torch.empty_like(x)
    if b == 0 or l == 0:
        return out
    n64 = n.to(torch.int64).contiguous()
    plan = launch_plan(b, l, int(padlen))
    if MAX_ROWS * plan.row_floats >= 2 ** 31:
        raise ValueError(f'butter_filtfilt: series of {l} samples are too '
                         f'long for 32-bit indices')
    scratch = (None if plan.shared else
               torch.empty(b * plan.row_floats, dtype=torch.float32,
                           device=x.device))
    launch('butter_filtfilt', _SIGNATURES, 'rtv_butter_filtfilt', x.device,
           x.data_ptr(), n64.data_ptr(), out.data_ptr(),
           None if scratch is None else scratch.data_ptr(), b, l, plan.rows,
           ctypes.byref(design))
    timing.count('lowpass_kernel_rows', b)
    return out


def butter_filtfilt(x: torch.Tensor, n: torch.Tensor, padlen: int,
                    sections) -> torch.Tensor:
    """(B, L) float32 series, (B,) live lengths -> (B, L) filtfilt output.

    CUDA tensor: the CUDA kernel.  CPU tensor: the plain version.  Nothing
    else.
    """
    if x.device.type == 'cuda':
        return _launch(x, n, padlen, sections)
    if x.device.type == 'cpu':
        return butter_filtfilt_reference(x, n, padlen, sections)
    raise ValueError(f'butter_filtfilt: unsupported device {x.device}')
