"""Host-side video IO: threaded decode, write, audio mux.

Port of ``retargetvid_tpu/io/video.py``.  The host decodes frames and hands
uint8 chunks to the device; resizes and inference run on the card.  The
reader decodes on a background thread into a bounded queue (the
counterpart of the reference's ``imutils.FileVideoStream`` decode thread,
``smartVidCrop.py:299``), so decode overlaps device work.  Decoding needs
OpenCV (``cv2``); without it the package still imports and IO raises.
The ingest and the CLI open files through ``io/native_reader.py:
open_reader``, which prefers the native C++ decoder to this reader.
"""

from __future__ import annotations

import os
import queue
import shutil
import subprocess
import threading
from typing import Iterator, Optional, Tuple

import numpy as np

try:
    import cv2
    _HAS_CV2 = True
except Exception:                                      # pragma: no cover
    _HAS_CV2 = False

__all__ = ["probe_video", "VideoReader", "write_video", "mux_audio"]


def _require_cv2():
    if not _HAS_CV2:
        raise RuntimeError('OpenCV (cv2) is required for video IO')


def probe_video(path) -> dict:
    """fps, frame count and dimensions (reference ``smartVidCrop.py:239-244``)."""
    _require_cv2()
    cap = cv2.VideoCapture(str(path))
    try:
        return {
            'fps': cap.get(cv2.CAP_PROP_FPS),
            'frame_count': int(cap.get(cv2.CAP_PROP_FRAME_COUNT)),
            'width': int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
            'height': int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
        }
    finally:
        cap.release()


class VideoReader:
    """Threaded decoder yielding RGB uint8 frame chunks.

    Decode runs on a daemon thread into a bounded queue; ``chunks(n)``
    yields (chunk (k, H, W, 3), start_index) with k <= n, the last chunk
    ragged.
    """

    def __init__(self, path, queue_size: int = 256, rgb: bool = True):
        _require_cv2()
        self.path = str(path)
        self.rgb = rgb
        self._queue: queue.Queue = queue.Queue(maxsize=queue_size)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        cap = cv2.VideoCapture(self.path)
        try:
            while not self._stop.is_set():
                ok, frame = cap.read()
                if not ok:
                    break
                if self.rgb:
                    frame = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
                self._queue.put(frame)
        finally:
            cap.release()
            self._queue.put(None)

    def frames(self) -> Iterator[np.ndarray]:
        while True:
            item = self._queue.get()
            if item is None:
                return
            yield item

    def chunks(self, chunk_size: int) -> Iterator[Tuple[np.ndarray, int]]:
        buf = []
        start = 0
        for frame in self.frames():
            buf.append(frame)
            if len(buf) == chunk_size:
                yield np.stack(buf), start
                start += len(buf)
                buf = []
        if buf:
            yield np.stack(buf), start

    def stop(self):
        self._stop.set()
        # Drain so the worker can exit.
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass


def write_video(path, frames: Iterator[np.ndarray], fps: float,
                size_wh: Optional[Tuple[int, int]] = None,
                fourcc: str = 'mp4v', is_rgb: bool = True) -> int:
    """Write frames to mp4; returns the number of frames written."""
    _require_cv2()
    writer = None
    n = 0
    for frame in frames:
        if writer is None:
            if size_wh is None:
                size_wh = (frame.shape[1], frame.shape[0])
            writer = cv2.VideoWriter(
                str(path), cv2.VideoWriter_fourcc(*fourcc), fps, size_wh)
        if is_rgb:
            frame = cv2.cvtColor(frame, cv2.COLOR_RGB2BGR)
        writer.write(frame)
        n += 1
    if writer is not None:
        writer.release()
    return n


def mux_audio(video_path, source_path, out_path=None) -> bool:
    """Copy the source video's audio track onto ``video_path`` with one
    ffmpeg remux (reference ``smartVidCrop.py:2556-2576``).  Returns False
    (no-op) when ffmpeg is unavailable or fails."""
    ffmpeg = shutil.which('ffmpeg')
    if ffmpeg is None:
        return False
    out_path = out_path or str(video_path)
    tmp = str(video_path) + '.tmp.mp4'
    cmd = [ffmpeg, '-y', '-i', str(video_path), '-i', str(source_path),
           '-map', '0:v', '-map', '1:a?', '-c:v', 'copy',
           '-c:a', 'aac', '-shortest', tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
    except subprocess.CalledProcessError:
        if os.path.exists(tmp):
            os.remove(tmp)
        return False
    os.replace(tmp, out_path)
    return True
