"""Inference datasets (reference ``unisal/data.py`` parity).

Port of the inference classes of ``retargetvid_tpu/train/data.py``:

- :class:`MemoryImageDataset` / :class:`MemoryFramesDataset`: in-memory
  frames, LANCZOS-resized to the optimal x32 grid and ImageNet-normalized
  on the device (``data.py:1241-1386``);
- :class:`FolderImageDataset` / :class:`FolderVideoDataset`: the images of
  a folder, or the frames of a video file read through
  ``io/native_reader.py:open_reader`` (``data.py:1106-1240``); ``cv2`` is
  imported where a file is read.

Preprocessed items are float32 tensors on the dataset's device
(``device=None`` means the GPU).  The training datasets are not ported.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from retargetvid_tpu_torch.device import resolve_device
from retargetvid_tpu_torch.pipeline.saliency import (
    get_optimal_out_size,
    preprocess_frames,
)

__all__ = ["MemoryImageDataset", "MemoryFramesDataset",
           "FolderImageDataset", "FolderVideoDataset"]

_IMG_EXTS = ('.png', '.jpg', '.jpeg', '.bmp')


def _read_images(files) -> list:
    import cv2
    return [cv2.cvtColor(cv2.imread(str(p)), cv2.COLOR_BGR2RGB)
            for p in files]


class MemoryImageDataset:
    """In-memory still images; each item preprocessed independently."""

    def __init__(self, images: Sequence[np.ndarray], device=None):
        self.images = list(images)
        self.device = resolve_device(device)
        self.frame_modulo = 1
        self.target_size_dict = {i: img.shape[:2]
                                 for i, img in enumerate(self.images)}
        self.out_size_dict = {i: get_optimal_out_size(img.shape[:2])
                              for i, img in enumerate(self.images)}

    def __len__(self):
        return len(self.images)

    def _preprocess(self, stack: np.ndarray, out_size) -> torch.Tensor:
        return preprocess_frames(torch.from_numpy(stack).to(self.device),
                                 out_size)

    def get_data(self, idx: int):
        out = self._preprocess(self.images[idx][None], self.out_size_dict[idx])
        return [1], out[0], self.target_size_dict[idx]

    def get_all_data(self) -> torch.Tensor:
        return self._preprocess(np.stack(self.images), self.out_size_dict[0])


class MemoryFramesDataset(MemoryImageDataset):
    """In-memory video frames with the reference's frame_modulo chunks."""

    def __init__(self, images, frame_modulo: int = 4, device=None):
        super().__init__(images, device)
        self.frame_modulo = frame_modulo
        self.out_size = self.out_size_dict[0]
        self.target_size = self.target_size_dict[0]

    def get_data(self, vid_nr: int, start: int = 0):
        n = len(self.images)
        frame_nrs = list(range(vid_nr, min(vid_nr + self.frame_modulo, n)))
        stack = np.stack([self.images[f] for f in frame_nrs])
        return frame_nrs, self._preprocess(stack, self.out_size), \
            self.target_size


class FolderImageDataset(MemoryImageDataset):
    """All images under a folder, in name order (``files``)."""

    def __init__(self, folder, device=None):
        self.files = sorted(p for p in Path(folder).iterdir()
                            if p.suffix.lower() in _IMG_EXTS)
        super().__init__(_read_images(self.files), device)


class FolderVideoDataset(MemoryFramesDataset):
    """Frames of one video folder (frame images) or a video file; raises
    ``FileNotFoundError`` where none can be read."""

    def __init__(self, path, frame_modulo: Optional[int] = None,
                 device=None):
        path = Path(path)
        if path.is_dir():
            images = _read_images(sorted(
                p for p in path.iterdir() if p.suffix.lower() in _IMG_EXTS))
        else:
            from retargetvid_tpu_torch.io.native_reader import open_reader
            reader = open_reader(path)
            try:
                images = list(reader.frames())
            finally:
                reader.stop()
        if not images:
            raise FileNotFoundError(f'no frames read from {path}')
        super().__init__(images, frame_modulo=frame_modulo or 5,
                         device=device)
