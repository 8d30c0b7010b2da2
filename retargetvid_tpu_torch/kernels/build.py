"""Build the CUDA kernels in ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/kernels/<name>-<hash>.so csrc/<name>.cu

The library lands in ``build/kernels/`` at the repository root (ignored by
git), named by a hash of its source and flags, so an edited source builds
anew.  Building happens at first use: the first library loaded builds every
missing one, as ``build_all`` does, one ``nvcc`` per source started at
once, so a fresh checkout waits for one compile, not one per kernel.  A
missing ``nvcc`` or a failed build raises: nothing falls
back to the plain PyTorch versions.

Every kernel is launched through :func:`launch`, on the current stream of
its tensors' device, and counted in :data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from collections import Counter
from pathlib import Path

import torch

__all__ = ["KERNEL_SOURCES", "BUILD_DIR", "LAUNCHES", "build_all",
           "load_library", "launch", "check_launch", "nvcc_command"]

CSRC_DIR = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / 'build' / 'kernels'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC')
#: Every kernel source of the port, by library name.
KERNEL_SOURCES = {'saliency_postprocess': 'saliency_postprocess.cu',
                  'butter_filtfilt': 'butter_filtfilt.cu',
                  'bn_act': 'bn_act.cu',
                  'saliency_smooth': 'saliency_smooth.cu'}

#: Launches of each kernel, by library name, in this process since the
#: count was last cleared.
LAUNCHES: Counter = Counter()

_LOADED: dict = {}


def _nvcc() -> str:
    cuda_home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    for cand in (shutil.which('nvcc'), os.path.join(cuda_home, 'bin', 'nvcc')):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError('nvcc not found (PATH, $CUDA_HOME/bin); the CUDA '
                       'kernels are built from source at first use')


def nvcc_command(source, target) -> list:
    """The ``nvcc`` command line that builds ``source`` into the shared
    library ``target``."""
    return [_nvcc(), *NVCC_FLAGS, '-o', str(target), str(source)]


def _lib_path(name: str) -> Path:
    src = CSRC_DIR / KERNEL_SOURCES[name]
    digest = hashlib.sha256(src.read_bytes() + ' '.join(NVCC_FLAGS).encode())
    return BUILD_DIR / f'{name}-{digest.hexdigest()[:16]}.so'


def _start_build(name: str):
    """Start ``nvcc`` for one kernel; returns (process, tmp, target) or None
    if the library is already built."""
    target = _lib_path(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
    os.close(fd)
    cmd = nvcc_command(CSRC_DIR / KERNEL_SOURCES[name], tmp)
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, target


def _finish_build(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, target = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f'nvcc failed for {name} (rc {proc.returncode}):'
                           f'\n{log}')
    os.replace(tmp, target)          # atomic: concurrent builders agree


def build_all(names=None) -> None:
    """Build every kernel (or ``names``), one ``nvcc`` per source, all
    started together."""
    names = list(KERNEL_SOURCES if names is None else names)
    started = [(n, _start_build(n)) for n in names]
    for n, s in started:
        _finish_build(n, s)


def load_library(name: str, signatures=None) -> ctypes.CDLL:
    """The kernel's shared library, built first if needed (with every other
    missing kernel of :data:`KERNEL_SOURCES`, compiled together).

    ``signatures`` maps each C function to ``(argtypes, restype)``; they are
    set once, when the library is first loaded."""
    lib = _LOADED.get(name)
    if lib is None:
        build_all()
        lib = ctypes.CDLL(str(_lib_path(name)))
        sigs = {'rtv_cuda_error_string': ([ctypes.c_int], ctypes.c_char_p),
                **(signatures or {})}
        for fn_name, (argtypes, restype) in sigs.items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = restype
        _LOADED[name] = lib
    return lib


def check_launch(lib: ctypes.CDLL, name: str, rc: int) -> None:
    """Raise if a launch returned a CUDA error."""
    if rc != 0:
        msg = lib.rtv_cuda_error_string(rc).decode()
        raise RuntimeError(f'{name} launch failed: CUDA error {rc} ({msg})')


def launch(name: str, signatures, fn_name: str, device, *args) -> None:
    """Launch kernel ``name``: its library's ``fn_name`` (typed by
    ``signatures``, see :func:`load_library`) called with ``args`` and the
    current stream of CUDA ``device``, on that device.  Raises on a CUDA
    error; counts the launch in :data:`LAUNCHES`."""
    lib = load_library(name, signatures)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, fn_name)(*args, stream)
    check_launch(lib, name, rc)
    LAUNCHES[name] += 1
