"""Output rendering: cropped video, padded (letterboxed) video, demo video.

Port of ``retargetvid_tpu/pipeline/render.py``, the host-side equivalents
of ``sc_renderer`` (reference ``smartVidCrop.py:1801-2154``) and
``sc_render_padded`` (``:2157-2213``; the reference version is dead code
with an inverted guard, implemented here with the intended semantics).
Rendering re-decodes the source and writes per-frame crops; it is an
optional output stage off the hot path.
"""

from __future__ import annotations

import pickle
from typing import Optional

import numpy as np
import torch

from retargetvid_tpu_torch.io.video import VideoReader, probe_video, write_video

__all__ = ["render_cropped", "render_padded", "render_demo",
           "render_cropped_pickle"]


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def render_cropped_pickle(pkl_path, boxes: np.ndarray, out_path=None) -> str:
    """Web-service mode: crop the frames of a reference-format ``.pkl``
    clip and write them back as ``<stem>_sc.pkl`` (reference
    ``sc_renderer``'s pickle branch, ``smartVidCrop.py:1820-1825,
    1879-1884``): the input contract with cropped ``frames``, updated
    ``w``/``h`` and the boxes.  Returns the output path."""
    with open(pkl_path, 'rb') as fp:
        data = pickle.load(fp)
    frames = np.asarray(data['frames'])
    boxes = np.asarray(boxes, int)
    n = min(len(frames), len(boxes))
    cropped = [frames[i][boxes[i][1]:boxes[i][3], boxes[i][0]:boxes[i][2]]
               for i in range(n)]
    out = {
        'fr': data.get('fr'),
        'frame_count': n,
        'w': int(boxes[0][2] - boxes[0][0]),
        'h': int(boxes[0][3] - boxes[0][1]),
        'frames': np.stack(cropped),
        'bbs': boxes[:n],
    }
    out_path = out_path or str(pkl_path).replace('.pkl', '_sc.pkl')
    with open(out_path, 'wb') as fp:
        pickle.dump(out, fp)
    return out_path


def render_cropped(video_path, boxes: np.ndarray, out_path,
                   fps: Optional[float] = None) -> int:
    """Write the cropped video: frame[y1:y2, x1:x2] per frame."""
    info = probe_video(video_path)
    fps = fps or info['fps']
    boxes = np.asarray(boxes, int)
    reader = VideoReader(video_path)

    def gen():
        for i, frame in enumerate(reader.frames()):
            if i >= len(boxes):
                break
            x1, y1, x2, y2 = boxes[i]
            yield frame[y1:y2, x1:x2]

    try:
        return write_video(str(out_path), gen(), fps)
    finally:
        reader.stop()


def render_padded(video_path, out_path, w_final: int, h_final: int,
                  fps: Optional[float] = None) -> int:
    """Letterbox the source into the target aspect ratio (intended
    semantics of the reference's broken ``sc_render_padded``)."""
    import cv2

    info = probe_video(video_path)
    fps = fps or info['fps']
    w, h = info['width'], info['height']
    target_ratio = w_final / h_final
    if w / h > target_ratio:
        new_w, new_h = w, int(round(w / target_ratio))
        pad_y, pad_x = (new_h - h) // 2, 0
    else:
        new_w, new_h = int(round(h * target_ratio)), h
        pad_y, pad_x = 0, (new_w - w) // 2
    reader = VideoReader(video_path)

    def gen():
        for frame in reader.frames():
            yield cv2.copyMakeBorder(
                frame, pad_y, new_h - h - pad_y, pad_x, new_w - w - pad_x,
                cv2.BORDER_CONSTANT, value=(0, 0, 0))

    try:
        return write_video(str(out_path), gen(), fps)
    finally:
        reader.stop()


def render_demo(video_path, vid_data: dict, geometry: dict, out_path,
                fps: Optional[float] = None) -> int:
    """Five-panel demo video (reference ``smartVidCrop.py:1924-2126``):
    original | saliency | filtered maps with centers/jump markers |
    crop-box overlay | the final cropped view (letterboxed into the panel).
    """
    import cv2

    info = probe_video(video_path)
    fps = fps or info['fps']
    boxes = np.asarray(geometry['boxes'], int)
    smaps = _host(vid_data['smaps'])
    filtered = geometry.get('smaps_filtered')
    if filtered is not None:
        filtered = _host(filtered)
    dx = geometry.get('dx')
    dy = geometry.get('dy')
    jumps = geometry.get('jumps')
    h_proc, w_proc = vid_data['h_process'], vid_data['w_process']
    inds_to_orig = vid_data['inds_to_orig']
    h, w = info['height'], info['width']
    panel_w = (w // 2) & ~1
    panel_h = (h // 2) & ~1
    reader = VideoReader(video_path)

    def panel(img):
        return cv2.resize(img, (panel_w, panel_h))

    def gen():
        for i, frame in enumerate(reader.frames()):
            if i >= len(boxes):
                break
            sel = min(inds_to_orig[min(i, len(inds_to_orig) - 1)],
                      len(smaps) - 1)
            smap_rgb = cv2.applyColorMap(smaps[sel],
                                         cv2.COLORMAP_JET)[:, :, ::-1]
            if filtered is not None:
                fmap_rgb = cv2.applyColorMap(
                    filtered[min(sel, len(filtered) - 1)].astype(np.uint8),
                    cv2.COLORMAP_JET)[:, :, ::-1].copy()
            else:
                fmap_rgb = smap_rgb.copy()
            # centers + focus-jump markers on the filtered panel
            if dx is not None and sel < len(dx):
                cx, cy = int(dx[sel]), int(dy[sel])
                color = (255, 255, 255)
                if jumps is not None and sel < len(jumps) \
                        and jumps[sel] < 255.0:
                    color = (255, 0, 255)
                cv2.circle(fmap_rgb, (np.clip(cx, 0, w_proc - 1),
                                      np.clip(cy, 0, h_proc - 1)),
                           3, color, -1)
            overlay = frame.copy()
            x1, y1, x2, y2 = boxes[i]
            cv2.rectangle(overlay, (x1, y1), (x2 - 1, y2 - 1), (0, 255, 0), 2)
            crop = frame[y1:y2, x1:x2]
            ch, cw = crop.shape[:2]
            scale = min(panel_w / cw, panel_h / ch)
            crop_r = cv2.resize(crop, (max(int(cw * scale), 2),
                                       max(int(ch * scale), 2)))
            crop_panel = np.zeros((panel_h, panel_w, 3), np.uint8)
            oy = (panel_h - crop_r.shape[0]) // 2
            ox = (panel_w - crop_r.shape[1]) // 2
            crop_panel[oy:oy + crop_r.shape[0],
                       ox:ox + crop_r.shape[1]] = crop_r
            yield np.concatenate(
                [panel(frame), panel(smap_rgb), panel(fmap_rgb),
                 panel(overlay), crop_panel], axis=1)

    try:
        return write_video(str(out_path), gen(), fps)
    finally:
        reader.stop()
