"""Inference and training datasets (reference ``unisal/data.py`` parity).

Port of ``retargetvid_tpu/train/data.py``.  Inference:

- :class:`MemoryImageDataset` / :class:`MemoryFramesDataset`: in-memory
  frames, LANCZOS-resized to the optimal x32 grid and ImageNet-normalized
  on the device (``data.py:1241-1386``);
- :class:`FolderImageDataset` / :class:`FolderVideoDataset`: the images of
  a folder, or the frames of a video file read through
  ``io/native_reader.py:open_reader`` (``data.py:1106-1240``); ``cv2`` is
  imported where a file is read.

Training (``data.py:118-808``), located through the same environment
variables as the reference (``DHF1K_DATA_DIR`` etc.) and yielding
(frames, saliency, fixations) NHWC batches for
``train/trainer.py:Trainer``: :class:`DHF1KDataset` (the 3-fold split,
12 x 5 windows, linspace validation starts), :class:`HollywoodDataset`,
:class:`UCFSportsDataset`, :class:`SALICONDataset` (COCO names, ``.mat``
fixations through ``scipy.io``), :class:`MIT1003Dataset` (10-fold split
seeded 27), :class:`MIT300Dataset` and :class:`ImgSizeBatchSampler`.
Saliency targets resize with Lanczos (MIT1003: bilinear, rounded to
uint8), fixations with nearest, through ``ops/resize.py``.

Preprocessed items are float32 tensors on the dataset's device
(``device=None`` means the GPU); files are read on the host with ``cv2``,
imported where a file is read.
"""

from __future__ import annotations

import copy
import os
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from retargetvid_tpu_torch.device import resolve_device
from retargetvid_tpu_torch.ops.resize import resize, round_half_up
from retargetvid_tpu_torch.pipeline.saliency import (
    get_optimal_out_size,
    preprocess_frames,
)

__all__ = ["MemoryImageDataset", "MemoryFramesDataset",
           "FolderImageDataset", "FolderVideoDataset",
           "DHF1KDataset", "SALICONDataset", "HollywoodDataset",
           "UCFSportsDataset", "MIT1003Dataset", "MIT300Dataset",
           "ImgSizeBatchSampler"]

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


# ---------------------------------------------------------------------------
# Training datasets (environment-variable located, like the reference)
# ---------------------------------------------------------------------------

def _env_dir(data_dir, env_var: str) -> str:
    data_dir = data_dir or os.environ.get(env_var)
    if not data_dir:
        raise FileNotFoundError(f'{env_var} is not set')
    return data_dir


def _maps(stack: np.ndarray, out_size, method: str, device) -> torch.Tensor:
    """(T, H, W) uint8 maps -> float32 (T, h, w) on ``device``."""
    return resize(torch.from_numpy(stack.astype(np.float32)).to(device),
                  out_size, method, channels_last=False)


def _frames(stack: np.ndarray, out_size, device) -> torch.Tensor:
    return preprocess_frames(torch.from_numpy(stack).to(device), out_size)


class _SaliencyFolderDataset:
    """Generic (frames, saliency, fixation) folder dataset: per-video
    directories holding ``images/``, ``maps/`` and ``fixation/``."""

    env_var: str = ''
    source: str = ''
    seq_len: int = 12
    frame_modulo: int = 5

    def __init__(self, phase: str = 'train', data_dir=None,
                 seq_len: Optional[int] = None, seed: int = 0, device=None):
        data_dir = data_dir or os.environ.get(self.env_var)
        if not data_dir:
            raise FileNotFoundError(
                f'{self.env_var} is not set; cannot locate {self.source} data')
        self.dir = Path(data_dir)
        self.phase = phase
        self.seq_len = seq_len or self.seq_len
        self.rng = np.random.default_rng(seed)
        self.device = resolve_device(device)
        self.videos = sorted(p for p in self.dir.iterdir() if p.is_dir())
        if not self.videos:
            raise FileNotFoundError(f'no videos under {self.dir}')

    def __len__(self):
        return len(self.videos)

    def _load_frames(self, folder: Path, frame_nrs) -> np.ndarray:
        import cv2
        files = sorted(folder.iterdir())
        return np.stack([cv2.cvtColor(cv2.imread(str(files[f])),
                                      cv2.COLOR_BGR2RGB) for f in frame_nrs])

    def sample(self, batch_size: int = 1):
        """One (x, sal, fix) training batch of random clips."""
        xs, sals, fixs = [], [], []
        for _ in range(batch_size):
            vid = self.videos[self.rng.integers(len(self.videos))]
            n = len(list((vid / 'images').iterdir()))
            max_start = max(n - self.seq_len * self.frame_modulo, 1)
            start = int(self.rng.integers(max_start))
            frame_nrs = list(range(start,
                                   min(start + self.seq_len * self.frame_modulo,
                                       n),
                                   self.frame_modulo))[:self.seq_len]
            frames = self._load_frames(vid / 'images', frame_nrs)
            sal = self._load_frames(vid / 'maps', frame_nrs)[..., 0]
            fix = self._load_frames(vid / 'fixation', frame_nrs)[..., 0]
            out_size = get_optimal_out_size(frames.shape[1:3])
            sal = torch.clamp(_maps(sal, out_size, 'lanczos', self.device),
                              min=0)
            sal = sal / torch.clamp(sal.sum(dim=(1, 2), keepdim=True), min=1)
            fix = _maps(fix, out_size, 'nearest', self.device)
            xs.append(_frames(frames, out_size, self.device))
            sals.append(sal[..., None])
            fixs.append((fix > 127).float()[..., None])
        return torch.stack(xs), torch.stack(sals), torch.stack(fixs)


class DHF1KDataset:
    """DHF1K with the reference's conventions (``unisal/data.py:536-766``):

    - layout ``$DHF1K_DATA_DIR/annotation/NNNN/{images,maps,fixation}/
      NNNN.png`` (4-digit, 1-based frame numbers);
    - 3-fold cross-validation over videos 1..700 with ``val_size=100``,
      ``x_val_step=2`` and unshuffled order (``x_val_seed=0``);
    - training samples are random ``seq_len * frame_modulo`` windows
      strided by ``frame_modulo`` (12 x 5); validation starts come from a
      linspace (``data.py:661-668``);
    - frames LANCZOS-resize to ``out_size`` and ImageNet-normalize; saliency
      normalizes to max 1, then to a distribution; fixations threshold at
      127.
    """

    source = 'DHF1K'
    env_var = 'DHF1K_DATA_DIR'
    n_train_val_videos = 700
    frame_rate = 30

    def __init__(self, phase: str = 'train', data_dir=None, seq_len: int = 12,
                 frame_modulo: int = 5, out_size=(224, 384),
                 target_size=(360, 640), val_size: int = 100,
                 n_x_val: int = 3, x_val_step: int = 2, x_val_seed: int = 0,
                 seq_per_vid: int = 1, seq_per_vid_val: int = 2,
                 subset=None, seed: int = 0, device=None):
        self.phase = phase
        self.train = phase == 'train'
        self.dir = Path(_env_dir(data_dir, self.env_var))
        self.seq_len = seq_len
        self.frame_modulo = frame_modulo
        self.clip_len = seq_len * frame_modulo
        self.out_size = tuple(out_size)
        self.target_size = tuple(target_size)
        self.rng = np.random.default_rng(seed)
        self.device = resolve_device(device)

        self.vid_nr_array = self._xval_split(val_size, n_x_val, x_val_step,
                                             x_val_seed)
        self.n_images_dict = self._count_images()
        self.samples = self._prepare_samples(seq_per_vid, seq_per_vid_val)
        if subset is not None:
            self.samples = self.samples[:int(len(self.samples) * subset)]
        self.target_size_dict = {v: self.target_size
                                 for v in self.n_images_dict}

    # -- structure ---------------------------------------------------------
    def _xval_split(self, val_size, n_x_val, x_val_step, x_val_seed):
        avail = self._available_videos()
        n_videos = len(avail) if avail else self.n_train_val_videos
        vid_nr_array = np.asarray(avail or list(range(1, n_videos + 1)))
        if x_val_seed > 0:
            rs = np.random.RandomState(x_val_seed)
            rs.shuffle(vid_nr_array)
        val_size = min(val_size, max(len(vid_nr_array) // n_x_val, 1))
        val_start = (len(vid_nr_array) - val_size) // \
            max(n_x_val - 1, 1) * x_val_step
        arr = vid_nr_array.tolist()
        if not self.train:
            return arr[val_start:val_start + val_size]
        del arr[val_start:val_start + val_size]
        return arr

    def _available_videos(self):
        root = self.dir / 'annotation'
        if not root.is_dir():
            raise FileNotFoundError(f'no annotation/ under {self.dir}')
        return sorted(int(p.name) for p in root.iterdir()
                      if p.is_dir() and p.name.isdigit())

    def _count_images(self):
        return {v: sum(1 for _ in (self.annotation_dir(v) / 'images')
                       .glob('*.png'))
                for v in self.vid_nr_array}

    def _prepare_samples(self, seq_per_vid, seq_per_vid_val):
        samples = []
        for vid_nr, n_images in self.n_images_dict.items():
            if n_images < self.clip_len:
                continue
            if self.train:
                samples += [(vid_nr, None)] * seq_per_vid
            else:
                x = n_images // (seq_per_vid_val * 2) - self.clip_len // 2
                start = max(1, x)
                end = min(n_images - self.clip_len, n_images - x)
                samples += [(vid_nr, int(s))
                            for s in np.linspace(start, end, seq_per_vid_val)]
        return samples

    def annotation_dir(self, vid_nr: int) -> Path:
        return self.dir / 'annotation' / f'{vid_nr:04d}'

    def data_file(self, vid_nr: int, f_nr: int, dkey: str) -> Path:
        folder = {'frame': 'images', 'sal': 'maps', 'fix': 'fixation'}[dkey]
        return self.annotation_dir(vid_nr) / folder / f'{f_nr:04d}.png'

    def __len__(self):
        return len(self.samples)

    # -- loading -----------------------------------------------------------
    def _load(self, vid_nr, f_nr, dkey):
        import cv2
        f = self.data_file(vid_nr, f_nr, dkey)
        data = (cv2.imread(str(f)) if dkey == 'frame'
                else cv2.imread(str(f), cv2.IMREAD_GRAYSCALE))
        if data is None:
            raise FileNotFoundError(f)
        if dkey == 'frame':
            data = np.ascontiguousarray(data[:, :, ::-1])
        return data

    def get_frame_nrs(self, vid_nr, start):
        return list(range(start, start + self.clip_len, self.frame_modulo))

    def get_data(self, vid_nr, start=None):
        """(frame_nrs, x, sal, fix, target_size), reference semantics."""
        n_images = self.n_images_dict[vid_nr]
        if start is None:
            max_start = n_images - self.clip_len + 1
            start = 1 if max_start <= 1 else int(
                self.rng.integers(1, max_start))
        frame_nrs = self.get_frame_nrs(vid_nr, start)
        frames, sal, fix = (np.stack([self._load(vid_nr, f, k)
                                      for f in frame_nrs])
                            for k in ('frame', 'sal', 'fix'))
        x, sal, fix = self._preprocess(frames, sal, fix)
        return frame_nrs, x, sal, fix, self.target_size_dict[vid_nr]

    def _preprocess(self, frames, sal, fix):
        x = _frames(frames, self.out_size, self.device)
        sal = torch.clamp(_maps(sal, self.out_size, 'lanczos', self.device),
                          min=0)
        sal = sal / torch.clamp(sal.amax(dim=(1, 2), keepdim=True), min=1e-6)
        sal = sal / torch.clamp(sal.sum(dim=(1, 2), keepdim=True), min=1e-6)
        fix = _maps(fix, self.out_size, 'nearest', self.device)
        return x, sal[..., None], (fix > 127).float()[..., None]

    def sample(self, batch_size: int = 1):
        """One (x, sal, fix) batch of random plan samples."""
        if not self.samples:
            raise ValueError(
                f'{self.source}: no clips of length {self.clip_len} '
                f'(seq_len*frame_modulo) fit the available videos')
        items = []
        for _ in range(batch_size):
            vid_nr, start = self.samples[
                int(self.rng.integers(len(self.samples)))]
            items.append(self.get_data(vid_nr, start)[1:4])
        return tuple(torch.stack(z) for z in zip(*items))


class HollywoodDataset(DHF1KDataset):
    """Hollywood-2 (``unisal/data.py:768-943``): per-shot directories
    ``actionclip{train|test}NNNNN_S/{images,maps,fixation}/
    actionclip{phase}NNNNN_FFFFF.png`` under ``training/`` or ``testing/``;
    vid ids are ``100 * vid_nr + shot_nr``; a register (scanned here, JSON
    in the reference) records per-shot frame counts and start numbers."""

    source = 'Hollywood'
    env_var = 'HOLLYWOOD_DATA_DIR'
    frame_rate = 24

    def __init__(self, phase: str = 'train', data_dir=None, seq_len: int = 12,
                 frame_modulo: int = 4, out_size=(224, 416),
                 val_size: int = 75, x_val_seed: int = 42, **kw):
        self.phase_str = 'test' if phase in ('eval', 'test') else 'train'
        data_dir = _env_dir(data_dir, self.env_var)
        sub = 'training' if phase in ('train', 'valid') else 'testing'
        super().__init__(phase=phase, data_dir=str(Path(data_dir) / sub),
                         seq_len=seq_len, frame_modulo=frame_modulo,
                         out_size=out_size, target_size=out_size,
                         val_size=val_size, x_val_seed=x_val_seed, **kw)

    def _available_videos(self):
        self._register = {}
        vids = set()
        for folder in sorted(self.dir.glob(f'actionclip{self.phase_str}*')):
            name = folder.stem
            base = 10 + len(self.phase_str)
            vid_nr = int(name[base:base + 5])
            shot_nr = int(name[-2:].replace('_', ''))
            image_files = sorted((folder / 'images').glob('actionclip*.png'))
            if not image_files:
                continue
            self._register[100 * vid_nr + shot_nr] = {
                'n_images': len(image_files),
                'start': int(image_files[0].stem[-5:]),
            }
            vids.add(vid_nr)
        if not self._register:
            raise FileNotFoundError(f'no actionclip dirs under {self.dir}')
        return sorted(vids)

    def _count_images(self):
        # vid_nr_array holds VIDEO numbers; expose SHOT-level entries whose
        # video survived the split (reference data.py:800-806).
        return {key: reg['n_images'] for key, reg in self._register.items()
                if key // 100 in self.vid_nr_array}

    def annotation_dir(self, key: int) -> Path:
        vid_nr, shot_nr = key // 100, key % 100
        return self.dir / f'actionclip{self.phase_str}{vid_nr:05d}_{shot_nr:1d}'

    def data_file(self, key: int, f_nr: int, dkey: str) -> Path:
        folder = {'frame': 'images', 'sal': 'maps', 'fix': 'fixation'}[dkey]
        f_nr = f_nr + self._register[key]['start'] - 1
        return self.annotation_dir(key) / folder / \
            f'actionclip{self.phase_str}{key // 100:05d}_{f_nr:05d}.png'


class UCFSportsDataset(DHF1KDataset):
    """UCF Sports (``unisal/data.py:946-1083``): per-video directories named
    ``<action>-<nr>`` under ``training/``/``testing/`` with
    ``{images,maps,fixation}/*.png``; frame files are sorted, not numbered
    by a fixed scheme."""

    source = 'UCFSports'
    env_var = 'UCFSPORTS_DATA_DIR'

    def __init__(self, phase: str = 'train', data_dir=None, seq_len: int = 12,
                 frame_modulo: int = 4, out_size=(256, 384),
                 val_size: int = 10, x_val_seed: int = 27, **kw):
        data_dir = _env_dir(data_dir, self.env_var)
        sub = 'training' if phase in ('train', 'valid') else 'testing'
        super().__init__(phase=phase, data_dir=str(Path(data_dir) / sub),
                         seq_len=seq_len, frame_modulo=frame_modulo,
                         out_size=out_size, target_size=out_size,
                         val_size=val_size, x_val_seed=x_val_seed, **kw)

    def _available_videos(self):
        self._names = {}
        for i, folder in enumerate(sorted(self.dir.glob('*-*'))):
            self._names[i + 1] = folder.stem
            self._names[(i + 1, 'files')] = [
                f.stem for f in sorted((folder / 'images').glob('*.png'))]
        if not self._names:
            raise FileNotFoundError(f'no <action>-<nr> dirs under {self.dir}')
        return sorted(k for k in self._names if isinstance(k, int))

    def annotation_dir(self, vid_nr: int) -> Path:
        return self.dir / self._names[vid_nr]

    def data_file(self, vid_nr: int, f_nr: int, dkey: str) -> Path:
        folder = {'frame': 'images', 'sal': 'maps', 'fix': 'fixation'}[dkey]
        stem = self._names[(vid_nr, 'files')][f_nr - 1]
        return self.annotation_dir(vid_nr) / folder / f'{stem}.png'


class SALICONDataset:
    """SALICON with the reference's COCO conventions
    (``unisal/data.py:49-130``): ``images/COCO_{train|val}2014_NNNNNNNNNNNN
    .jpg``, ``maps/{phase}/...png``, ``fixations/{phase}/...png`` (raw
    ``.mat`` fixations converted on first access, reference
    ``get_fixation_map``)."""

    source = 'SALICON'
    env_var = 'SALICON_DATA_DIR'
    frame_modulo = 1

    def __init__(self, phase: str = 'train', data_dir=None,
                 out_size=(288, 384), target_size=(480, 640), subset=None,
                 seed: int = 0, device=None):
        self.phase = phase
        self.train = phase == 'train'
        self.dir = Path(_env_dir(data_dir, self.env_var))
        self.out_size = tuple(out_size)
        self.target_size = tuple(target_size)
        self.phase_str = 'val' if phase in ('valid', 'eval') else phase
        self.file_stem = f'COCO_{self.phase_str}2014_'
        self.rng = np.random.default_rng(seed)
        self.device = resolve_device(device)

        self.samples = sorted(
            int(f.stem[-12:])
            for f in (self.dir / 'images').glob(self.file_stem + '*.jpg'))
        if not self.samples:
            raise FileNotFoundError(
                f'no {self.file_stem}*.jpg under {self.dir}/images')
        if subset is not None:
            self.samples = self.samples[:int(len(self.samples) * subset)]
        self.n_images_dict = {n: 1 for n in self.samples}
        self.target_size_dict = {n: self.target_size for n in self.samples}

    def __len__(self):
        return len(self.samples)

    def _img_file(self, img_nr):
        return self.dir / 'images' / f'{self.file_stem}{img_nr:012d}.jpg'

    def _map_file(self, img_nr):
        return self.dir / 'maps' / self.phase_str / \
            f'{self.file_stem}{img_nr:012d}.png'

    def _fix_file(self, img_nr):
        return self.dir / 'fixations' / self.phase_str / \
            f'{self.file_stem}{img_nr:012d}.png'

    def get_fixation_map(self, img_nr):
        import cv2
        f = self._fix_file(img_nr)
        if f.exists():
            return cv2.imread(str(f), cv2.IMREAD_GRAYSCALE)
        # Raw .mat fixations (reference data.py:97-111).
        import scipy.io
        fix_data = scipy.io.loadmat(f.with_suffix('.mat'))
        fix_map = np.zeros(fix_data['resolution'].tolist()[0], np.uint8)
        for gaze in fix_data['gaze'][:, 0]:
            pts = gaze[2]
            fix_map[pts[:, 1] - 1, pts[:, 0] - 1] = 255
        cv2.imwrite(str(f), fix_map)
        return fix_map

    def get_data(self, img_nr):
        import cv2
        img = cv2.cvtColor(cv2.imread(str(self._img_file(img_nr))),
                           cv2.COLOR_BGR2RGB)
        sal = cv2.imread(str(self._map_file(img_nr)), cv2.IMREAD_GRAYSCALE)
        fix = self.get_fixation_map(img_nr)
        x = _frames(img[None], self.out_size, self.device)[0]
        sal_r = torch.clamp(_maps(sal[None], self.out_size, 'lanczos',
                                  self.device)[0], min=0)
        sal_r = sal_r / torch.clamp(sal_r.sum(), min=1e-6)
        fix_r = _maps(fix[None], self.out_size, 'nearest', self.device)[0]
        return ([1], x, sal_r[..., None], (fix_r > 127).float()[..., None],
                self.target_size)

    def sample(self, batch_size: int = 1):
        items = []
        for _ in range(batch_size):
            img_nr = self.samples[int(self.rng.integers(len(self.samples)))]
            items.append(self.get_data(img_nr)[1:4])
        return tuple(torch.stack(z)[:, None] for z in zip(*items))


# ---------------------------------------------------------------------------
# MIT1003 / MIT300 (reference unisal/data.py:237-516)
# ---------------------------------------------------------------------------

#: The restricted train-time grid of x32 network sizes
#: (reference ``MIT1003Dataset.get_out_size_train``, data.py:426-441).
_MIT_TRAIN_SIZES = ((8, 13), (9, 13), (9, 12), (12, 9), (13, 9))


def _best_out_size(img_size, candidates):
    ar = img_size[0] / img_size[1]
    best, best_ratio = None, -1.0
    for n1, n2 in candidates:
        this_ar = n1 / n2
        ratio = min(ar, this_ar) / max(ar, this_ar)
        if ratio > best_ratio:
            best_ratio = ratio
            best = (n1, n2)
    return (best[0] * 32, best[1] * 32)


def _eval_size_grid():
    return [(n1, n2) for n1 in range(7, 14) for n2 in range(7, 14)
            if 100 <= n1 * n2 <= 120]


class MIT1003Dataset:
    """MIT1003 still images (``unisal/data.py:322-516``): images under
    ``ALLSTIMULI/ALLSTIMULI`` (``*.jpeg``), maps/points under
    ``ALLFIXATIONMAPS/ALLFIXATIONMAPS`` (``<stem>_fixMap.jpg`` /
    ``<stem>_fixPts.jpg``); 10-fold cross-validation split seeded with 27;
    train-time out sizes from a restricted grid with target size 2x,
    eval-time from the full [7,13]^2 grid with the original size as
    target.
    """

    source = 'MIT1003'
    n_train_val_images = 1003

    def __init__(self, phase: str = 'train', subset=None, data_dir=None,
                 n_x_val: int = 10, x_val_step: Optional[int] = 0,
                 x_val_seed: int = 27, device=None):
        self.phase = phase
        self.train = phase == 'train'
        self.dir = Path(_env_dir(data_dir, 'MIT1003_DATA_DIR'))
        self.n_x_val = n_x_val
        self.x_val_step = x_val_step
        self.x_val_seed = x_val_seed
        self.device = resolve_device(device)

        self.all_image_files = self._scan_files()
        n_images = min(self.n_train_val_images, len(self.all_image_files))

        # Cross-validation split (reference data.py:346-366).
        if x_val_step is None:
            self.samples = list(range(n_images))
        else:
            assert x_val_step < n_x_val
            samples = np.arange(0, n_images)
            if x_val_seed > 0:
                np.random.RandomState(x_val_seed).shuffle(samples)
            val_start = int(len(samples) / n_x_val * x_val_step)
            val_end = int(len(samples) / n_x_val * (x_val_step + 1))
            samples = samples.tolist()
            if not self.train:
                self.samples = samples[val_start:val_end]
            else:
                del samples[val_start:val_end]
                self.samples = samples
        if subset is not None:
            self.samples = self.samples[:int(len(self.samples) * subset)]

        self.size_dict = self._compute_sizes()
        self.target_size_dict = {
            i: self.size_dict[i]['target_size'] for i in self.samples}
        self.n_images_dict = {i: 1 for i in self.samples}
        self.frame_modulo = 1

    @property
    def img_dir(self) -> Path:
        return self.dir / 'ALLSTIMULI' / 'ALLSTIMULI'

    @property
    def fix_dir(self) -> Path:
        return self.dir / 'ALLFIXATIONMAPS' / 'ALLFIXATIONMAPS'

    def _scan_files(self):
        files = []
        for img_file in sorted(self.img_dir.glob('*.jpeg')):
            entry = {'img': img_file.name,
                     'map': img_file.stem + '_fixMap.jpg',
                     'pts': img_file.stem + '_fixPts.jpg'}
            assert (self.fix_dir / entry['map']).exists(), entry['map']
            assert (self.fix_dir / entry['pts']).exists(), entry['pts']
            files.append(entry)
        if not files:
            raise FileNotFoundError(f'no *.jpeg stimuli under {self.img_dir}')
        return files

    def _compute_sizes(self):
        import cv2
        size_dict = {}
        for i in self.samples:
            img = cv2.imread(str(self.img_dir / self.all_image_files[i]['img']))
            img_size = img.shape[:2]
            if self.phase in ('train', 'valid'):
                out_size = _best_out_size(img_size, _MIT_TRAIN_SIZES)
                target_size = tuple(s * 2 for s in out_size)
            else:
                out_size = _best_out_size(img_size, _eval_size_grid())
                target_size = img_size
            size_dict[i] = {'img_size': img_size, 'out_size': out_size,
                            'target_size': target_size}
        return size_dict

    def __len__(self):
        return len(self.samples)

    def get_data(self, img_idx: int):
        """(frame_nrs, x, sal, fix, target_size) for one image: LANCZOS
        frames, bilinear saliency rounded to uint8, NEAREST fixations."""
        import cv2
        entry = self.all_image_files[img_idx]
        out_size = self.size_dict[img_idx]['out_size']
        img = cv2.cvtColor(cv2.imread(str(self.img_dir / entry['img'])),
                           cv2.COLOR_BGR2RGB)
        sal = cv2.imread(str(self.fix_dir / entry['map']),
                         cv2.IMREAD_GRAYSCALE)
        fix = cv2.imread(str(self.fix_dir / entry['pts']),
                         cv2.IMREAD_GRAYSCALE)
        x = _frames(img[None], out_size, self.device)[0]
        sal_r = torch.clamp(round_half_up(
            _maps(sal[None], out_size, 'linear', self.device)), 0, 255)[0]
        sal_r = sal_r / torch.clamp(sal_r.sum(), min=1.0)
        fix_r = _maps(fix[None], out_size, 'nearest', self.device)[0]
        return ([1], x, sal_r[..., None], (fix_r > 127).float()[..., None],
                self.size_dict[img_idx]['target_size'])

    def batches(self, batch_size: int = 4, shuffle: bool = True,
                seed: int = 27):
        """Same-out-size batch iterator (see :class:`ImgSizeBatchSampler`)."""
        sampler = ImgSizeBatchSampler(self, batch_size=batch_size,
                                      shuffle=shuffle, seed=seed)
        for idx_batch in sampler:
            items = [self.get_data(self.samples[i])[1:4] for i in idx_batch]
            yield tuple(torch.stack(z)[:, None] for z in zip(*items))


class MIT300Dataset:
    """MIT300 benchmark images (test only; reference ``data.py:237-319``):
    ``BenchmarkIMAGES/*.jpg`` sorted by the numeric part of the stem, out
    sizes from the full [7,13]^2 grid, original size as target."""

    source = 'MIT300'

    def __init__(self, phase: str = 'test', data_dir=None, device=None):
        import cv2
        assert phase == 'test'
        self.dir = Path(_env_dir(data_dir, 'MIT300_DATA_DIR')) / \
            'BenchmarkIMAGES'
        self.device = resolve_device(device)
        file_list = sorted(self.dir.glob('*.jpg'),
                           key=lambda x: int(x.stem[1:min(4, len(x.stem))]))
        if not file_list:
            raise FileNotFoundError(f'no *.jpg under {self.dir}')
        self.samples = []
        self.target_size_dict = {}
        grid = _eval_size_grid()
        for i, f in enumerate(file_list):
            img_size = cv2.imread(str(f)).shape[:2]
            self.samples.append((f.name, _best_out_size(img_size, grid)))
            self.target_size_dict[i] = img_size
        self.frame_modulo = 1

    def __len__(self):
        return len(self.samples)

    def get_data(self, item: int):
        import cv2
        name, out_size = self.samples[item]
        img = cv2.cvtColor(cv2.imread(str(self.dir / name)),
                           cv2.COLOR_BGR2RGB)
        return ([1], _frames(img[None], out_size, self.device)[0],
                self.target_size_dict[item])


class ImgSizeBatchSampler:
    """Group sample indices into batches of one network out-size
    (reference ``data.py:175-235``): MIT1003 images vary in aspect, and a
    batch stacks to one shape.  With ``shuffle`` the order is unseeded, as
    in the reference."""

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 27):
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed

        out_sizes = [dataset.size_dict[i]['out_size']
                     for i in dataset.samples]
        self.out_size_set = sorted(set(out_sizes))
        self.sample_idx_dict = {s: [] for s in self.out_size_set}
        for sample_idx, out_size in enumerate(out_sizes):
            self.sample_idx_dict[out_size].append(sample_idx)

        self.len = 0
        self.n_batches_dict = {}
        for out_size, idxs in self.sample_idx_dict.items():
            n = len(idxs) // self.batch_size
            if not drop_last and len(idxs) % self.batch_size:
                n += 1
            self.len += n
            self.n_batches_dict[out_size] = n

    def __iter__(self):
        rng = np.random.RandomState(self.seed if not self.shuffle else None)
        batch_array = [s for s, n in self.n_batches_dict.items()
                       for _ in range(n)]
        rng.shuffle(batch_array)
        pools = copy.deepcopy(self.sample_idx_dict)
        for idxs in pools.values():
            rng.shuffle(idxs)
        for out_size in batch_array:
            batch = pools[out_size][:self.batch_size]
            del pools[out_size][:self.batch_size]
            if batch:
                yield batch

    def __len__(self):
        return self.len
