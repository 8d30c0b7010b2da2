"""The port's native C++ video reader vs the JAX package's and the Python
reader.

The library builds from the port's own sources (``io/native/``) into
``build/native/``; on this host, which has g++ and the OpenCV headers,
``open_reader`` must choose it, so a silently broken build fails here.
Both packages' libraries export the same C symbols and are loaded in this
one process side by side.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_ingest_stream import stream_frames, write_mp4

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
FC, H, W = 45, 72, 128


@pytest.fixture(scope='module')
def mp4(tmp_path_factory):
    return write_mp4(tmp_path_factory.mktemp('native') / 'clip.mp4',
                     stream_frames(FC, H, W, cuts=(20,)))


def _all(reader, chunk=None):
    try:
        if chunk is None:
            return np.stack(list(reader.frames()))
        parts = list(reader.chunks(chunk))
        assert [s for _, s in parts] == list(range(0, FC, chunk))
        return np.concatenate([c for c, _ in parts])
    finally:
        reader.stop()


def test_builds_from_its_own_sources(tmp_path):
    from retargetvid_tpu_torch.io import native_reader

    assert native_reader.native_available()
    lib = native_reader.library_path()
    assert lib.is_file() and lib.parent == REPO / 'build' / 'native'
    assert 'build/' in (REPO / '.gitignore').read_text().split()
    assert native_reader.NATIVE_DIR == \
        REPO / 'retargetvid_tpu_torch' / 'io' / 'native'
    target = tmp_path / 'libvideoreader.so'
    native_reader.build_library(target)
    assert target.stat().st_size > 0


def test_build_keeps_its_own_flags_under_environment_flags(tmp_path,
                                                           monkeypatch):
    """``CXXFLAGS`` from the environment (as toolchains export them) still
    link a loadable shared object, and name another library than the
    default flags do."""
    import ctypes
    import os

    from retargetvid_tpu_torch.io import native_reader

    default = native_reader.library_path()
    monkeypatch.setenv('CXXFLAGS', '-O1')
    assert native_reader.library_path() != default
    target = tmp_path / 'libvideoreader.so'
    native_reader.build_library(target)
    lib = ctypes.CDLL(str(target), mode=os.RTLD_LOCAL)
    assert lib.vr_open and lib.vr_next_batch


def test_frames_equal_jax_and_python_readers(mp4):
    from retargetvid_tpu.io.native_reader import NativeVideoReader as JNative
    from retargetvid_tpu.io.native_reader import native_available
    from retargetvid_tpu_torch.io.native_reader import NativeVideoReader
    from retargetvid_tpu_torch.io.video import VideoReader, probe_video

    assert native_available()
    port, jax_reader = NativeVideoReader(mp4), JNative(mp4)
    probe = (port.fps, port.frame_count, port.width, port.height)
    assert probe == (jax_reader.fps, jax_reader.frame_count,
                     jax_reader.width, jax_reader.height)
    info = probe_video(mp4)
    assert probe == (info['fps'], info['frame_count'], info['width'],
                     info['height']) == (30.0, FC, W, H)
    ragged = _all(port, 7)
    assert ragged.shape == (FC, H, W, 3) and ragged.dtype == np.uint8
    assert np.array_equal(ragged, _all(jax_reader, 7))
    assert np.array_equal(_all(NativeVideoReader(mp4)), ragged)
    assert np.array_equal(_all(JNative(mp4)), ragged)
    assert np.array_equal(_all(VideoReader(mp4)), ragged)
    assert np.array_equal(_all(VideoReader(mp4), 7), ragged)


def test_open_reader_prefers_native(mp4, tmp_path):
    from retargetvid_tpu_torch.io.native_reader import (
        NativeVideoReader,
        open_reader,
    )
    from retargetvid_tpu_torch.io.video import VideoReader

    reader = open_reader(mp4)
    assert isinstance(reader, NativeVideoReader)
    reader.stop()
    reader.stop()                                   # idempotent
    reader = open_reader(mp4, prefer_native=False)
    assert isinstance(reader, VideoReader)
    reader.stop()
    with pytest.raises(FileNotFoundError):
        NativeVideoReader(tmp_path / 'missing.mp4')


def test_streaming_ingest_reads_through_the_native_reader(mp4, monkeypatch):
    """``read_and_segment_video`` opens the file with the native reader
    and hands every frame on."""
    from retargetvid_tpu_torch.config import sc_init_crop_params
    from retargetvid_tpu_torch.io import native_reader
    from retargetvid_tpu_torch.pipeline.ingest import read_and_segment_video

    opened = []
    real = native_reader.open_reader

    def spy(*args, **kw):
        opened.append(real(*args, **kw))
        return opened[-1]

    monkeypatch.setattr(native_reader, 'open_reader', spy)
    seen = []

    def saliency_fn(frames):
        seen.append(int(frames.shape[0]))
        return np.zeros(frames.shape[:3], np.uint8)

    vd = read_and_segment_video(
        mp4, dict(sc_init_crop_params(), out_ratio='1:3'),
        lambda context: np.zeros(len(context), np.float32), saliency_fn,
        device='cpu')
    assert [type(r) for r in opened] == [native_reader.NativeVideoReader]
    assert vd['fc'] == FC and sum(seen) == vd['fc_sel'] > 0
