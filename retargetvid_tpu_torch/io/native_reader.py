"""ctypes bindings for the native C++ video decoder.

Port of ``retargetvid_tpu/io/native_reader.py``.  ``NativeVideoReader``
has :class:`retargetvid_tpu_torch.io.video.VideoReader`'s ``chunks`` /
``frames`` / ``stop`` surface, but decode and BGR->RGB run on a C++ worker
thread (``io/native/videoreader.cpp``): no GIL on the decode path, and a
chunk is assembled by one copy per frame into a numpy buffer.

The shared object is built at first use from the port's own source with
``make -C io/native`` (g++ and ``pkg-config opencv4``) into
``build/native/`` at the repository root (ignored by git), named by a hash
of the source, the Makefile, the compiler and its flags, so an edited
source or another toolchain builds anew.  It is
loaded with ``RTLD_LOCAL``: the JAX package's library exports the same
symbols, and one process may hold both.  Where the build fails (no
compiler or no OpenCV headers), :func:`open_reader` falls back to the
Python reader, as the JAX package does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Iterator, Tuple

import numpy as np

from retargetvid_tpu_torch.io.video import VideoReader

__all__ = ["NativeVideoReader", "native_available", "library_path",
           "build_library", "open_reader"]

NATIVE_DIR = Path(__file__).resolve().parent / 'native'
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / 'build' / 'native'
_SOURCES = ('videoreader.cpp', 'Makefile')

_LIB = None
_BUILD_FAILED = False


def _build_inputs() -> bytes:
    """What the build reads besides the sources: the compiler and the
    flags ``make`` takes from the environment, and OpenCV's include
    flags."""
    try:
        opencv = subprocess.run(['pkg-config', '--cflags', 'opencv4'],
                                capture_output=True, text=True).stdout
    except FileNotFoundError:
        opencv = ''
    return '\0'.join((os.environ.get('CXX', 'g++'),
                      os.environ.get('CXXFLAGS', ''),
                      opencv.strip())).encode()


def library_path() -> Path:
    """Where the library of the current sources, compiler and flags is
    built."""
    digest = hashlib.sha256(b''.join((NATIVE_DIR / f).read_bytes()
                                     for f in _SOURCES) + _build_inputs())
    return BUILD_DIR / f'libvideoreader-{digest.hexdigest()[:16]}.so'


def build_library(target) -> None:
    """Build the library into ``target``; raises
    ``subprocess.CalledProcessError`` (or ``FileNotFoundError`` without
    ``make``) when the build fails."""
    subprocess.run(['make', '-s', '-B', '-C', str(NATIVE_DIR),
                    f'OUT={Path(target).resolve()}'],
                   check=True, capture_output=True)


def _load_library():
    global _LIB, _BUILD_FAILED
    if _LIB is not None or _BUILD_FAILED:
        return _LIB
    path = library_path()
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
        os.close(fd)
        try:
            build_library(tmp)
        except (subprocess.CalledProcessError, FileNotFoundError):
            os.unlink(tmp)
            _BUILD_FAILED = True
            return None
        os.replace(tmp, path)           # atomic: concurrent builds agree
    try:
        lib = ctypes.CDLL(str(path), mode=os.RTLD_LOCAL)
    except OSError:
        _BUILD_FAILED = True
        return None
    lib.vr_open.restype = ctypes.c_void_p
    lib.vr_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.vr_probe.restype = None
    lib.vr_probe.argtypes = [ctypes.c_void_p,
                             ctypes.POINTER(ctypes.c_double)]
    lib.vr_next_batch.restype = ctypes.c_int
    lib.vr_next_batch.argtypes = [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_uint8),
                                  ctypes.c_int]
    lib.vr_close.restype = None
    lib.vr_close.argtypes = [ctypes.c_void_p]
    lib.vr_last_error.restype = ctypes.c_char_p
    lib.vr_last_error.argtypes = []
    _LIB = lib
    return lib


def native_available() -> bool:
    """Whether the native library builds and loads on this host."""
    return _load_library() is not None


class NativeVideoReader:
    """C++-threaded decoder yielding RGB uint8 frame chunks; ``fps``,
    ``frame_count``, ``width`` and ``height`` are the file's probe."""

    def __init__(self, path, queue_size: int = 256):
        lib = _load_library()
        if lib is None:
            raise RuntimeError('native video reader unavailable '
                               '(build failed or OpenCV missing)')
        self._lib = lib
        self._handle = lib.vr_open(str(path).encode(), queue_size)
        if not self._handle:
            raise FileNotFoundError(
                lib.vr_last_error().decode() or f'cannot open {path}')
        probe = (ctypes.c_double * 4)()
        lib.vr_probe(self._handle, probe)
        self.fps = float(probe[0])
        self.frame_count = int(probe[1])
        self.width = int(probe[2])
        self.height = int(probe[3])

    def chunks(self, chunk_size: int) -> Iterator[Tuple[np.ndarray, int]]:
        """(chunk (k, H, W, 3), start index) with k <= ``chunk_size``, the
        last chunk ragged."""
        start = 0
        while self._handle:
            buf = np.empty((chunk_size, self.height, self.width, 3),
                           np.uint8)
            n = self._lib.vr_next_batch(
                self._handle,
                buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                chunk_size)
            if n <= 0:
                return
            yield buf[:n], start
            start += n
            if n < chunk_size:
                return

    def frames(self) -> Iterator[np.ndarray]:
        for chunk, _ in self.chunks(64):
            yield from chunk

    def stop(self):
        """Stop the worker and free the decoder (idempotent)."""
        if self._handle:
            self._lib.vr_close(self._handle)
            self._handle = None

    def __del__(self):                                  # pragma: no cover
        try:
            self.stop()
        except Exception:
            pass


def open_reader(path, queue_size: int = 256, prefer_native: bool = True):
    """The best reader this host has: the native C++ decoder, else the
    Python reader (``io/video.py:VideoReader``)."""
    if prefer_native and native_available():
        try:
            return NativeVideoReader(path, queue_size)
        except (RuntimeError, FileNotFoundError):
            pass
    return VideoReader(path, queue_size)
