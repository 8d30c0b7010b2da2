"""Debug plotting: the center-series signals.

Port of ``retargetvid_tpu/utils/plots.py:plot_signals,
plot_smoothing_preview``, the plots ``smart_vid_crop(plots_fn=...)``
draws: the 2x2 signal plot of interpolated/smoothed center series with
shot boundaries (reference ``sc_plot_signals``,
``smartVidCrop.py:1752-1796``) and the smoothing preview
(``:2490-2500``).  ``matplotlib`` is imported only when a plot is drawn.
"""

from __future__ import annotations

import numpy as np

__all__ = ["plot_signals", "plot_smoothing_preview"]


def _pyplot():
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    return plt


def plot_signals(vid_data: dict, plots_fn: str) -> None:
    """2x2 plot: x/y interpolated vs smoothed series with shot boundaries."""
    if not plots_fn:
        return
    plt = _pyplot()
    fig, axes = plt.subplots(2, 2, figsize=(12, 6))
    t = np.arange(len(vid_data['dxi']))
    pairs = [('dxi', 'x interpolated'), ('dxs', 'x smoothed'),
             ('dyi', 'y interpolated'), ('dys', 'y smoothed')]
    for ax, (key, title) in zip(axes.ravel(), pairs):
        ax.plot(t[:len(vid_data[key])], vid_data[key], lw=0.8)
        for seg in np.asarray(vid_data.get('segmentation', [])):
            ax.axvline(seg[0], color='red', lw=0.5, alpha=0.6)
        ax.set_title(title)
    fig.tight_layout()
    fig.savefig(plots_fn, bbox_inches='tight')
    plt.close(fig)


def plot_smoothing_preview(vid_data: dict, out_fn: str = 'debug_preview.png'):
    """Two-row preview of interpolated/low-passed/smoothed series."""
    plt = _pyplot()
    fig, (ax1, ax2) = plt.subplots(nrows=2, ncols=1)
    ts = np.arange(len(vid_data['dxi']))
    ax1.plot(ts, vid_data['dxi'])
    if 'dxl' in vid_data:
        ax1.plot(ts[:len(vid_data['dxl'])], vid_data['dxl'], color='green')
    ax1.plot(ts[:len(vid_data['dxs'])], vid_data['dxs'], color='red')
    ax2.plot(ts, vid_data['dyi'])
    if 'dyl' in vid_data:
        ax2.plot(ts[:len(vid_data['dyl'])], vid_data['dyl'], color='green')
    ax2.plot(ts[:len(vid_data['dys'])], vid_data['dys'], color='red')
    fig.savefig(out_fn, bbox_inches='tight')
    plt.close(fig)

