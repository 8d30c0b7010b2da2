"""The single-device forward-step entry and the multi-device dry run of
mesh training and sharded serving.

Counterparts of ``__graft_entry__.py``: :func:`entry` is the flagship's
forward step on one device (Lanczos preprocess, static UNISAL, the
postprocess kernel); :func:`dryrun_multichip` one full UNISAL train step on
an n-rank (dp, sp, tp) mesh, then the sharded one-shot program's swap
check.  JAX re-executes itself onto n virtual CPU devices
when fewer are visible; here, where fewer than n GPUs are visible, the n
ranks are CPU processes joined over gloo (one process per device, the
port's process model), else one process per GPU over NCCL.

    python -m retargetvid_tpu_torch.dryrun 4
"""

from __future__ import annotations

import multiprocessing
import pickle
import shutil
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch

__all__ = ["entry", "dryrun_multichip", "mesh_sizes", "TINY_UNISAL"]

#: ``__graft_entry__.py:_tiny_unisal``: what the dry run checks is the
#: layout over the mesh, which the channel counts do not change.
TINY_UNISAL = dict(cnn_widen_factor=0.25, cnn_last_channel=None,
                   rnn_input_channels=32, rnn_hidden_channels=32,
                   smoothing_ksize=11, smoothing_rank=4)


def entry(device=None, model=None):
    """``(fn, example_args)``: the forward step of the flagship, UNISAL in
    the crop pipeline's configuration, batched over frames.

    ``fn(model, frames)``: (T, H, W, 3) uint8 frames -> Lanczos preprocess
    to 256x416 -> static UNISAL at SALICON to 140x250 -> per-frame exp and
    max-normalize to (T, 140, 250) uint8 (the postprocess kernel on the
    card).  ``example_args``: ``model`` (default: seeded full-width UNISAL)
    on ``device`` and 8 seeded frames of 140x250 there.  ``device=None``
    means the GPU.
    """
    from retargetvid_tpu_torch.device import resolve_device
    from retargetvid_tpu_torch.kernels.postprocess import saliency_postprocess
    from retargetvid_tpu_torch.models.init import seeded_init_
    from retargetvid_tpu_torch.models.unisal import UNISAL
    from retargetvid_tpu_torch.pipeline.saliency import preprocess_frames

    device = resolve_device(device)
    if model is None:
        model = seeded_init_(UNISAL(), 0)
    model = model.to(device).eval()

    def fn(model, frames):
        with torch.inference_mode():
            x = preprocess_frames(frames, (256, 416))
            logp = model(x[:, None], target_size=(140, 250),
                         source='SALICON')
            return saliency_postprocess(
                logp[:, 0, :, :, 0].to(torch.float32).contiguous())

    frames = torch.from_numpy(np.random.default_rng(0).integers(
        0, 255, (8, 140, 250, 3), np.uint8)).to(device)
    return fn, (model, frames)


def mesh_sizes(n: int) -> tuple:
    """JAX's factorization: (n/4, 2, 2), else (n/2, 2, 1), else
    (n, 1, 1)."""
    if n % 4 == 0:
        return (n // 4, 2, 2)
    if n % 2 == 0:
        return (n // 2, 2, 1)
    return (n, 1, 1)


def _train_step(mesh, device):
    """Stage 1: one DHF1K train step (backbone trained, dropout live) of
    the tiny UNISAL at ``tp_threshold=16`` on JAX's shapes: b = max(2, dp)
    rounded up to a multiple of dp, t=2, 64x64; the batch's rows over sp."""
    from retargetvid_tpu_torch.train.trainer import Trainer

    dp = mesh.shape['dp']
    b, t, h, w = max(2, dp), 2, 64, 64
    b += (-b) % dp
    tr = Trainer(model_cfg=TINY_UNISAL, device=device, steps_per_epoch=10)
    tr.init_state(rng_seed=0, mesh=mesh, tp_threshold=16)
    tr.generator.manual_seed(1)
    x = np.random.default_rng(0).normal(0, 1, (b, t, h, w, 3)).astype(
        np.float32)
    sal = np.zeros((b, t, h, w, 1), np.float32)
    sal[:, :, h // 2, w // 2, 0] = 1.0
    sal = sal / sal.sum(axis=(2, 3, 4), keepdims=True)
    fix = (np.random.default_rng(1).random((b, t, h, w, 1)) > 0.99).astype(
        np.float32)
    x, sal, fix, layout = tr._shard_arrays(x, sal, fix)
    tr.state, m = tr.step_fn('DHF1K', False, True)(tr.state, x, sal, fix,
                                                   layout)
    metrics = {k: float(v) for k, v in m.items()}
    if not np.isfinite(metrics['loss']):
        raise FloatingPointError(f'non-finite training loss: {metrics}')
    return tr, metrics, {'batch': [b, t, h, w],
                         'tp_split_weights': len(tr._tp_dims)}


def _swap_check(mesh, trainer, device):
    """Stage 2: ``ShardedOneShot`` (tiny TransNet, head biased; the
    trained UNISAL, gathered whole) on two distinct 12-frame 70x125 clips
    in dp-sized batches, then in the other order: the probabilities and
    boxes follow the clip, and the two clips differ."""
    from retargetvid_tpu_torch.config import sc_init_crop_params
    from retargetvid_tpu_torch.convert import load_flax_variables
    from retargetvid_tpu_torch.models.init import seeded_init_
    from retargetvid_tpu_torch.models.transnet import TransNetV1
    from retargetvid_tpu_torch.models.unisal import UNISAL
    from retargetvid_tpu_torch.parallel.runner import ShardedOneShot

    h, w, n = 70, 125, 12
    yy, xx = np.mgrid[0:h, 0:w]

    def make_clip(phase):
        frames = np.zeros((n, h, w, 3), np.uint8)
        for t in range(n):
            cx = 20 + 3 * t + 25 * phase
            blob = 220 * np.exp(-(((yy - 35) ** 2 + (xx - cx) ** 2) / 200.0))
            frames[t] = blob[..., None].astype(np.uint8)
        return frames

    tn = seeded_init_(TransNetV1(f=2, l=3, s=2, d=16), 0)
    with torch.no_grad():
        tn.dense2.bias.copy_(torch.tensor([5.0, -5.0]))
    un = load_flax_variables(UNISAL(**TINY_UNISAL), trainer._flax_tree())
    cp = sc_init_crop_params()
    cp['out_ratio'] = '1:3'
    cp['max_input_d'] = 125
    runner = ShardedOneShot(mesh, tn, un, dtype=torch.float32, s_pad=4,
                            tn_fullseq=True, fc_bucket=16, t_sel_bucket=8,
                            device=device)
    kw = dict(fps=6.0, w_final=41, h_final=125)
    clips = [make_clip(0), make_clip(1)]
    dp = mesh.shape['dp']

    def run(order):
        outs = []
        for i in range(0, len(order), dp):
            outs += runner.run_batch([clips[c] for c in order[i:i + dp]],
                                     cp, **kw)
        return outs

    slots = max(dp, 2) + (-max(dp, 2)) % dp
    order = [i % 2 for i in range(slots)]
    outs = run(order)
    swapped = run([1 - c for c in order])
    for o in outs + swapped:
        if o['boxes'].shape != (n, 4) or o['overrun']:
            raise AssertionError(f'unexpected outputs: boxes '
                                 f'{o["boxes"].shape}, overrun '
                                 f'{o["overrun"]}')
    if np.array_equal(outs[0]['probs'], outs[1]['probs']):
        raise AssertionError('distinct clips produced identical shot probs')
    for i, c in enumerate(order):
        src = outs[order.index(1 - c)]
        for key in ('probs', 'boxes'):
            if not np.array_equal(swapped[i][key], src[key]):
                raise AssertionError(f'{key} did not follow the clip across '
                                     'shard positions')
    return {'clips': len(clips), 'batches_per_order': slots // dp,
            'follow_the_clip': True}


def _rank_main(rank, n, init_method, out_path, use_cuda, timeout_s):
    from retargetvid_tpu_torch.parallel import distributed
    from retargetvid_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    status, t0 = 0, time.monotonic()
    try:
        if use_cuda:
            torch.cuda.set_device(rank)
        device = f'cuda:{rank}' if use_cuda else 'cpu'
        distributed.initialize(rank, n, init_method,
                               'nccl' if use_cuda else 'gloo', timeout_s)
        mesh = make_mesh(n, axis_sizes=mesh_sizes(n), device=device)
        trainer, metrics, info = _train_step(mesh, device)
        t1 = time.monotonic()
        swap = _swap_check(mesh, trainer, device)
        result = ('ok', {'mesh': dict(mesh.shape), 'coords': mesh.coords,
                         'device': device, 'metrics': metrics, **info,
                         'swap_check': swap,
                         'stage_s': [t1 - t0, time.monotonic() - t1]})
    except Exception:                               # noqa: BLE001
        result, status = ('error', traceback.format_exc()), 1
    finally:
        distributed.shutdown()
    with open(out_path, 'wb') as fp:
        pickle.dump(result, fp)
    sys.exit(status)


def dryrun_multichip(n_devices: int, timeout_s: float = 600.0) -> dict:
    """Run the dry run on ``n_devices`` ranks (see the module docstring)
    and return rank 0's record: the mesh, the step's metrics (a finite
    loss) and the swap check.  Raises if any rank fails or outlives
    ``timeout_s``."""
    n = int(n_devices)
    use_cuda = torch.cuda.is_available() and \
        torch.cuda.device_count() >= n
    tmp = Path(tempfile.mkdtemp(prefix='rtv_dryrun_'))
    ctx = multiprocessing.get_context('spawn')
    outs = [tmp / f'rank{r}.pkl' for r in range(n)]
    procs = [ctx.Process(target=_rank_main, args=(
        r, n, f'file://{tmp / "store"}', str(outs[r]), use_cuda,
        timeout_s)) for r in range(n)]
    t0 = time.monotonic()
    try:
        for p in procs:
            p.start()
        for p in procs:
            p.join(max(0.0, t0 + timeout_s - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        if hung:
            raise RuntimeError(f'dryrun ranks {hung} still running after '
                               f'{timeout_s} s')
        results = [pickle.loads(o.read_bytes()) if o.exists() else None
                   for o in outs]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for r, (res, p) in enumerate(zip(results, procs)):
        if res is None or res[0] != 'ok' or p.exitcode != 0:
            raise RuntimeError(f'dryrun rank {r} failed (exit {p.exitcode}):'
                               f'\n{res[1] if res else "no result"}')
    rec = dict(results[0][1], ranks=n,
               backend='nccl' if use_cuda else 'gloo',
               seconds=time.monotonic() - t0)
    print(f'dryrun_multichip({n}): mesh={rec["mesh"]} '
          f'loss={rec["metrics"]["loss"]:.4f} '
          f'kld={rec["metrics"]["kld"]:.4f} sharded-oneshot ok', flush=True)
    return rec


if __name__ == '__main__':
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
