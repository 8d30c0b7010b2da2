"""Butterworth filtfilt: the kernel's argument and launch plan, the CPU
path against the benchmark's frozen reference, and the CUDA kernel against
its plain version (on a card only).

No JAX here, so the ``cuda`` tests run on a machine without it:
``python -m pytest tests/test_torch_filtfilt.py -m cuda --noconftest``.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

#: (cutoff, fs, order): the ICIP preset, the ISM preset, ICIP's at 24 fps.
DESIGNS = {'icip': (2.0, 30.0, 5), 'ism': (1.0, 30.0, 2),
           'icip_24fps': (2.0, 24.0, 5)}
#: The bench clip's (2 axes x 8 segments, 512 frames), a small and a large.
SHAPES = ((16, 512), (2, 33), (64, 1024))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA GPU (run on the card: python -m pytest '
                    'tests/test_torch_filtfilt.py -m cuda --noconftest)')
    return torch.device('cuda')


def _series(b, L, seed):
    """Seeded random walks like the centre series (pixels)."""
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.normal(0, 3, (b, L)), axis=1).astype(np.float32)


def _lengths(b, L, padlen, rot=0):
    """Live lengths 1, padlen, padlen + 1, L - 1, L over the rows, from the
    ``rot``-th on."""
    cycle = (1, padlen, padlen + 1, L - 1, L)
    return np.asarray([cycle[(r + rot) % 5] for r in range(b)], np.int64)


@pytest.mark.parametrize('name', sorted(DESIGNS))
def test_pack_design(name):
    """Each section's float32 coefficients in the kernel's argument, in
    order; padlen and the count beside them; unused slots zero."""
    from retargetvid_tpu_torch.kernels.filtfilt import (
        MAX_SECTIONS,
        pack_design,
    )
    from retargetvid_tpu_torch.ops.filters import _butter_design

    padlen, sections = _butter_design(*DESIGNS[name])
    design = pack_design(padlen, sections)
    order = DESIGNS[name][2]
    assert (design.n_sections, design.padlen) == (len(sections), padlen)
    assert (design.n_sections, design.padlen) == (
        {5: (3, 18), 2: (1, 9)}[order])
    for k in range(MAX_SECTIONS):
        got = [getattr(design.sec[k], f) for f in
               ('b0', 'm00', 'm01', 'm10', 'm11', 'v0', 'v1', 'zi0', 'zi1')]
        if k < len(sections):
            b0, m, v, zi = sections[k]
            want = [b0, m[0][0], m[0][1], m[1][0], m[1][1], *v, *zi]
            assert np.array_equal(np.float32(got), np.float32(want))
            assert got[2] == 1.0 and got[4] == 0.0     # M's literal entries
        else:
            assert got == [0.0] * 9


def test_pack_design_refuses_long_design():
    from retargetvid_tpu_torch.kernels.filtfilt import (
        MAX_SECTIONS,
        pack_design,
    )
    from retargetvid_tpu_torch.ops.filters import _butter_design

    padlen, sections = _butter_design(2.0, 30.0, 2 * MAX_SECTIONS + 1)
    assert len(sections) == MAX_SECTIONS + 1
    with pytest.raises(ValueError, match='second-order sections'):
        pack_design(padlen, sections)


@pytest.mark.parametrize('b, L, padlen, rows, ctas, shared', [
    (16, 512, 18, 16, 1, True),       # the bench clip: one CTA, 70 KB
    (2, 33, 9, 2, 1, True),
    (64, 1024, 18, 22, 3, True),      # 32 rows would overflow: 3 x 22
    (4, 40000, 18, 4, 1, False),      # a row over 227 KB: device scratch
])
def test_launch_plan(b, L, padlen, rows, ctas, shared):
    from retargetvid_tpu_torch.kernels.filtfilt import (
        MAX_ROWS,
        SMEM_LIMIT,
        launch_plan,
    )
    plan = launch_plan(b, L, padlen)
    assert (plan.rows, plan.ctas, plan.shared) == (rows, ctas, shared)
    assert plan.row_floats == 2 * (L + 2 * padlen) + 1
    assert plan.row_floats % 2 == 1          # an odd stride: no bank clash
    assert plan.rows <= MAX_ROWS and plan.rows * plan.ctas >= b
    assert plan.smem_bytes <= SMEM_LIMIT


@pytest.mark.parametrize('name', ['icip', 'ism'])
def test_cpu_path_is_the_plain_version(name, monkeypatch):
    """On the CPU ``butter_lowpass_filter`` never loads the library and is
    bit-equal to the benchmark's frozen copy of the op chain."""
    from portbench.reference.filters import butter_lowpass_filter as frozen
    from retargetvid_tpu_torch.kernels import build
    from retargetvid_tpu_torch.ops.filters import (
        _butter_design,
        butter_lowpass_filter,
    )

    def refuse(*args, **kwargs):
        raise AssertionError('the CPU path loaded a kernel library')

    monkeypatch.setattr(build, 'load_library', refuse)
    monkeypatch.setattr(build, 'build_all', refuse)
    launches = build.LAUNCHES['butter_filtfilt']
    padlen, _ = _butter_design(*DESIGNS[name])
    for b, L in SHAPES[:2]:
        for rot in range(5 if b < 5 else 1):
            x = torch.from_numpy(_series(b, L, seed=rot))
            n = torch.from_numpy(_lengths(b, L, padlen, rot))
            out = butter_lowpass_filter(x, n, *DESIGNS[name])
            assert torch.equal(out, frozen(x, n, *DESIGNS[name]))
    assert build.LAUNCHES['butter_filtfilt'] == launches


def test_unsupported_device():
    from retargetvid_tpu_torch.kernels.filtfilt import butter_filtfilt
    from retargetvid_tpu_torch.ops.filters import _butter_design

    padlen, sections = _butter_design(*DESIGNS['icip'])
    x = torch.zeros((2, 33), device='meta')
    n = torch.zeros((2,), dtype=torch.int64, device='meta')
    with pytest.raises(ValueError, match='unsupported device'):
        butter_filtfilt(x, n, padlen, sections)


@pytest.mark.cuda
@pytest.mark.parametrize('shape', SHAPES, ids=lambda s: 'x'.join(map(str, s)))
@pytest.mark.parametrize('name', sorted(DESIGNS))
def test_kernel_bit_equal(cuda_device, name, shape, monkeypatch):
    """The kernel's whole (B, L) result, and ``butter_lowpass_filter``'s,
    bit-equal to the plain version on the card, at live lengths 1, padlen,
    padlen + 1, L - 1 and L on every row."""
    from retargetvid_tpu_torch.kernels import filtfilt
    from retargetvid_tpu_torch.kernels.build import LAUNCHES
    from retargetvid_tpu_torch.ops import filters

    b, L = shape
    padlen, sections = filters._butter_design(*DESIGNS[name])
    for rot in range(5 if b < 5 else 1):
        x = torch.from_numpy(_series(b, L, seed=10 + rot)).to(cuda_device)
        n = torch.from_numpy(_lengths(b, L, padlen, rot)).to(cuda_device)
        launches = LAUNCHES['butter_filtfilt']
        got = filtfilt.butter_filtfilt(x, n, padlen, sections)
        assert LAUNCHES['butter_filtfilt'] == launches + 1
        want = filtfilt.butter_filtfilt_reference(x, n, padlen, sections)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (
            f'{int((got != want).sum())} of {got.numel()} values differ')
        out = filters.butter_lowpass_filter(x, n, *DESIGNS[name])
        with monkeypatch.context() as m:
            m.setattr(filters, 'butter_filtfilt',
                      filtfilt.butter_filtfilt_reference)
            plain = filters.butter_lowpass_filter(x, n, *DESIGNS[name])
        assert torch.equal(out, plain)


@pytest.mark.cuda
@pytest.mark.parametrize('shape', SHAPES[:2],
                         ids=lambda s: 'x'.join(map(str, s)))
def test_kernel_scratch_path(cuda_device, shape, monkeypatch):
    """With no shared memory to spare, the rows' areas live in device
    scratch: the same values."""
    from retargetvid_tpu_torch.kernels import filtfilt
    from retargetvid_tpu_torch.ops.filters import _butter_design

    monkeypatch.setattr(filtfilt, 'SMEM_LIMIT', 4)
    b, L = shape
    padlen, sections = _butter_design(*DESIGNS['icip'])
    assert not filtfilt.launch_plan(b, L, padlen).shared
    for rot in range(5 if b < 5 else 1):
        x = torch.from_numpy(_series(b, L, seed=20 + rot)).to(cuda_device)
        n = torch.from_numpy(_lengths(b, L, padlen, rot)).to(cuda_device)
        got = filtfilt.butter_filtfilt(x, n, padlen, sections)
        want = filtfilt.butter_filtfilt_reference(x, n, padlen, sections)
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_kernel_refuses_and_fails_loudly(cuda_device):
    """A non-contiguous or float64 input and an over-long design raise
    before a launch; a launch the C side refuses raises with its error."""
    import ctypes

    from retargetvid_tpu_torch.kernels import filtfilt
    from retargetvid_tpu_torch.kernels.build import LAUNCHES, launch
    from retargetvid_tpu_torch.ops.filters import _butter_design

    padlen, sections = _butter_design(*DESIGNS['icip'])
    x = torch.from_numpy(_series(16, 512, seed=3)).to(cuda_device)
    n = torch.full((16,), 512, dtype=torch.int64, device=cuda_device)
    launches = LAUNCHES['butter_filtfilt']
    with pytest.raises(ValueError, match='contiguous'):
        filtfilt.butter_filtfilt(x[:, ::2], n, padlen, sections)
    with pytest.raises(TypeError, match='float32'):
        filtfilt.butter_filtfilt(x.double(), n, padlen, sections)
    long_padlen, long_sections = _butter_design(
        2.0, 30.0, 2 * filtfilt.MAX_SECTIONS + 1)
    with pytest.raises(ValueError, match='second-order sections'):
        filtfilt.butter_filtfilt(x, n, long_padlen, long_sections)
    assert LAUNCHES['butter_filtfilt'] == launches
    # 0 rows per block: the launcher refuses, the launch raises.
    out = torch.empty_like(x)
    design = filtfilt.pack_design(padlen, sections)
    with pytest.raises(RuntimeError, match='CUDA error'):
        launch('butter_filtfilt', filtfilt._SIGNATURES, 'rtv_butter_filtfilt',
               x.device, x.data_ptr(), n.data_ptr(), out.data_ptr(), None,
               16, 512, 0, ctypes.byref(design))
    assert LAUNCHES['butter_filtfilt'] == launches


@pytest.mark.cuda
def test_one_launch_per_dispatch(cuda_device):
    """A one-shot ICIP ``dispatch`` on the card launches the kernel once per
    clip, and only once, on the x and y series of every padded segment
    (the counter ``lowpass_kernel_rows``)."""
    from retargetvid_tpu_torch import bench
    from retargetvid_tpu_torch.config import sc_init_crop_params
    from retargetvid_tpu_torch.kernels.build import LAUNCHES
    from retargetvid_tpu_torch.ops.boxes import calc_dest_size
    from retargetvid_tpu_torch.pipeline.oneshot import (
        OneShotClipProgram,
        StageTimer,
    )

    cp = sc_init_crop_params()
    cp['out_ratio'] = '1:3'
    dest = calc_dest_size(640, 360, '1:3')
    tn, un = bench.build_models()
    with torch.no_grad():           # sampling's every-skip regime, as bench.py
        tn.dense2.bias.copy_(torch.tensor(bench.HEAD_BIAS))
    program = OneShotClipProgram(tn, un, tn_fullseq=True)
    program.timer = StageTimer()
    for seed in (0, 1):
        clip = torch.from_numpy(bench.make_clip(seed=seed)).to(cuda_device)
        launches = LAUNCHES['butter_filtfilt']
        out = program.collect(program.dispatch(
            clip, cp, fps=30.0, w_final=dest['w_final'],
            h_final=dest['h_final']))
        assert LAUNCHES['butter_filtfilt'] == launches + 1
        assert out['boxes'].shape[0] == clip.shape[0]
    assert program.timer.counts()['lowpass_kernel_rows'] == \
        [2 * program.s_pad] * 2
