"""RetargetVid annotation and result-file data contracts.

Port of ``retargetvid_tpu/eval/annotations.py`` (reference ``README.md:16``,
``retargetvid_eval.py:65-90``): one ``x1,y1,x2,y2`` integer crop box per
frame per line, files named ``NNN_{1-3,3-1}.txt`` for DHF1K videos 1-100
and 601-700, six annotators shipped as ``annotations/annotator_{1..6}.zip``.
"""

from __future__ import annotations

import zipfile
from pathlib import Path

import numpy as np

__all__ = ["VID_INDS", "ASPECT_RATIOS", "N_ANNOTATORS", "read_boxes_file",
           "write_boxes_file", "load_annotations", "frame_counts_from_annots"]

#: The 200 RetargetVid video indices (reference ``retargetvid_eval.py:68``).
VID_INDS: tuple = tuple(list(range(1, 101)) + list(range(601, 701)))

#: Target aspect ratios of the benchmark.
ASPECT_RATIOS: tuple = ('1-3', '3-1')

#: Number of human annotators.
N_ANNOTATORS = 6


def read_boxes_file(path) -> np.ndarray:
    """Read one crop-box-per-line txt -> int array (frames, 4)."""
    with open(path) as fp:
        lines = fp.read().splitlines()
    out = np.empty((len(lines), 4), dtype=np.int64)
    for i, line in enumerate(lines):
        c = line.split(',')
        out[i] = (int(c[0]), int(c[1]), int(c[2]), int(c[3]))
    return out


def write_boxes_file(path, boxes) -> None:
    """Write an (frames, 4) int array as one ``x1,y1,x2,y2`` line per frame."""
    boxes = np.asarray(boxes)
    with open(path, 'w') as fp:
        for bb in boxes:
            fp.write('%d,%d,%d,%d\n' % (int(bb[0]), int(bb[1]),
                                        int(bb[2]), int(bb[3])))


def _ensure_extracted(annotations_dir: Path, annotator: str) -> Path:
    """Extract ``<annotator>.zip`` beside it if the directory is missing."""
    annot_path = annotations_dir / annotator
    if annot_path.is_dir():
        return annot_path
    zip_path = annotations_dir / f'{annotator}.zip'
    if not zip_path.is_file():
        raise FileNotFoundError(
            f'Neither {annot_path} nor {zip_path} exists; download the '
            f'RetargetVid annotations.')
    with zipfile.ZipFile(zip_path) as zf:
        zf.extractall(annotations_dir)
    return annot_path


def load_annotations(annotations_dir, vid_inds=VID_INDS,
                     extract_to=None) -> list:
    """All annotators' ground truth: ``annots[user][ar][vid_ind] ->
    (frames, 4) int array``, the reference evaluator's nesting.

    If ``annotations_dir`` is read-only, pass ``extract_to`` for the unzip
    destination.
    """
    annotations_dir = Path(annotations_dir)
    src_dir = Path(extract_to) if extract_to is not None else annotations_dir

    annots = []
    for annot_index in range(1, N_ANNOTATORS + 1):
        annotator = f'annotator_{annot_index}'
        annot_path = src_dir / annotator
        if not annot_path.is_dir():
            zip_path = annotations_dir / f'{annotator}.zip'
            if zip_path.is_file() and extract_to is not None:
                src_dir.mkdir(parents=True, exist_ok=True)
                with zipfile.ZipFile(zip_path) as zf:
                    zf.extractall(src_dir)
            else:
                annot_path = _ensure_extracted(annotations_dir, annotator)
        user = {}
        for ar in ASPECT_RATIOS:
            user[ar] = {}
            for vid_ind in vid_inds:
                file = annot_path / ('%03d_%s.txt' % (vid_ind, ar))
                user[ar][vid_ind] = read_boxes_file(file)
        annots.append(user)

    # Validity checks (reference retargetvid_eval.py:84-90).
    for user in annots:
        if len(user) != len(ASPECT_RATIOS):
            raise ValueError('aspect ratio count mismatch')
        for ar in ASPECT_RATIOS:
            if len(user[ar]) != len(vid_inds):
                raise ValueError('video count mismatch')
    return annots


def frame_counts_from_annots(annots, vid_inds=VID_INDS) -> dict:
    """Frame count per video, taken from annotator 1 (reference ``:98-100``)."""
    return {v: len(annots[0]['1-3'][v]) for v in vid_inds}
