"""Model runtime / size measurement (reference ``train.py:1458-1528``).

Port of ``retargetvid_tpu/train/measure.py``: ``measure_runtime`` times
single-frame static inference on the devices the caller names, with CUDA
events on the card and the wall clock on the CPU (a missing GPU raises,
never a silent skip); ``measure_model_size`` counts parameters and bytes.
"""

from __future__ import annotations

import copy
import time

import torch

from retargetvid_tpu_torch.device import resolve_device

__all__ = ["measure_runtime", "measure_model_size"]


def measure_runtime(model, *, input_hw=(256, 416), target_hw=(140, 250),
                    source='SALICON', n_iters: int = 20,
                    devices=('cuda', 'cpu')) -> dict:
    """Frames per second of a single-frame static forward per device:
    ``{'fps_device': ..., 'fps_cpu': ...}`` (``fps_device`` is the card)."""
    results = {}
    for name in devices:
        dev = resolve_device(name)
        m = copy.deepcopy(model).to(dev)
        x = torch.zeros((1, 1, *input_hw, 3), device=dev)
        with torch.no_grad(), m.bn_mode(False):
            def fwd():
                return m(x, target_size=target_hw, source=source,
                         static=True)
            fwd()                                    # warm-up
            if dev.type == 'cuda':
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(n_iters):
                    fwd()
                end.record()
                end.synchronize()
                dt = start.elapsed_time(end) / 1e3 / n_iters
            else:
                t0 = time.perf_counter()
                for _ in range(n_iters):
                    fwd()
                dt = (time.perf_counter() - t0) / n_iters
        key = 'fps_device' if dev.type == 'cuda' else f'fps_{dev.type}'
        results[key] = 1.0 / dt
    return results


def measure_model_size(model) -> dict:
    """Parameter count and byte size of ``model``'s parameters."""
    params = list(model.parameters())
    n_params = sum(p.numel() for p in params)
    n_bytes = sum(p.numel() * p.element_size() for p in params)
    return {'n_params': n_params, 'bytes': n_bytes,
            'mb': n_bytes / (1024 ** 2)}
