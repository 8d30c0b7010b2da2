"""``Trainer.run_inference`` against JAX on the CPU, and the trainer on the
card.

CPU: ``train/measure.py`` against JAX's model size, and at
``TINY_UNISAL_CFG`` from the same seeded variables, the port's
``run_inference`` (dynamic DHF1K, 9 frames of 64x64, ``frame_modulo`` 3,
``seq_len`` 2, and static SALICON) against JAX's: uint8 maps at most 1
LSB apart on at most 0.1% of pixels (the ``exp`` of the tail differs by an
ulp between numpy and torch, ROADMAP Queue 3), scores within 1e-3; the
postprocess runs once per dynamic clip and once per 32 static frames.

``cuda`` (skipped without a card; run there with ``python -m pytest
tests/test_torch_train_card.py -m cuda --noconftest``, which needs no
JAX): 3 train steps of the narrow model in float32 with TF32 off, dropout
masks all ones on both devices, from the same weights (statistics drawn
from a seed) and batch, card vs CPU: losses within 1e-4 relative,
parameters and statistics within 1e-4 in relative L2 (chained steps move
single entries by more, see ``tests/test_torch_trainer.py``);
``run_inference`` launches the CUDA kernel exactly once per dynamic clip
and once per 32 frames of a static one.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

TINY = dict(cnn_widen_factor=0.25, cnn_last_channel=None,
            rnn_input_channels=32, rnn_hidden_channels=32,
            smoothing_ksize=11, smoothing_rank=4)


def clip(t=9, hw=(64, 64), seed=0):
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 255, (t, *hw, 3)).astype(np.uint8)
    sal = rng.random((t, *hw)).astype(np.float32)
    fix = (rng.random((t, *hw)) > 0.98).astype(np.float32)
    return frames, sal, fix


def counting(monkeypatch):
    """Count the predictor's postprocess calls (kernel or plain)."""
    from retargetvid_tpu_torch.pipeline import saliency
    real = saliency.saliency_postprocess
    calls = [0]

    def wrapped(logp):
        calls[0] += 1
        return real(logp)

    monkeypatch.setattr(saliency, 'saliency_postprocess', wrapped)
    return calls


@pytest.mark.parametrize('source', ['DHF1K', 'SALICON'])
def test_run_inference_matches_jax(source, monkeypatch):
    from retargetvid_tpu.train.trainer import Trainer as JTrainer
    from retargetvid_tpu_torch.convert import state_dict_to_flax
    from retargetvid_tpu_torch.train.trainer import Trainer

    pt = Trainer(model_cfg=TINY, device='cpu')
    pt.init_state(rng_seed=6)
    tree = state_dict_to_flax(pt.model)
    jt = JTrainer(model_cfg=TINY)
    jt.init_state(variables=tree)
    frames, sal, fix = clip(t=9 if source == 'DHF1K' else 40)
    kw = dict(source=source, frame_modulo=3, seq_len=2, sal=sal, fix=fix)
    ref, ref_scores = jt.run_inference(frames, **kw)
    calls = counting(monkeypatch)
    maps, scores = pt.run_inference(frames, **kw)
    assert calls[0] == (1 if source == 'DHF1K' else 2)
    assert maps.shape == ref.shape == frames.shape[:3]
    assert maps.dtype == np.uint8
    diff = np.abs(maps.astype(np.int16) - np.asarray(ref).astype(np.int16))
    print(f'run_inference {source}: {int((diff > 0).sum())} of {diff.size} '
          f'pixels differ, max {int(diff.max())} LSB; scores {scores}')
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    assert set(scores) == set(ref_scores)
    for k in ref_scores:
        assert np.isfinite(scores[k])
        np.testing.assert_allclose(scores[k], ref_scores[k], atol=1e-3,
                                   err_msg=k)
    # bn_train is restored after the inference.
    assert pt.model.bn_train


def test_measure_matches_jax_and_needs_the_card():
    """``measure_model_size`` counts what JAX's does on the same variables;
    ``measure_runtime`` times the CPU when asked and raises for a missing
    card instead of skipping it."""
    from retargetvid_tpu.train.measure import measure_model_size as jsize
    from retargetvid_tpu_torch.convert import state_dict_to_flax
    from retargetvid_tpu_torch.models.unisal import UNISAL
    from retargetvid_tpu_torch.train.measure import (
        measure_model_size,
        measure_runtime,
    )

    model = UNISAL(**TINY)
    assert measure_model_size(model) == jsize(state_dict_to_flax(model))
    fps = measure_runtime(model, input_hw=(64, 64), target_hw=(32, 32),
                          n_iters=2, devices=('cpu',))
    assert set(fps) == {'fps_cpu'} and fps['fps_cpu'] > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA'):
            measure_runtime(model, devices=('cuda', 'cpu'))


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA GPU (run on the card: python -m pytest '
                    'tests/test_torch_train_card.py -m cuda --noconftest)')


def _batch(seed=0, b=2, t=3, hw=64):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (b, t, hw, hw, 3)).astype(np.float32)
    sal = rng.random((b, t, hw, hw, 1)).astype(np.float32) ** 2
    sal /= sal.sum(axis=(2, 3, 4), keepdims=True)
    fix = (rng.random((b, t, hw, hw, 1)) > 0.98).astype(np.float32)
    return x, sal, fix


@pytest.mark.cuda
def test_train_steps_card_vs_cpu(monkeypatch):
    _card()
    from retargetvid_tpu_torch.convert import state_dict_to_flax
    from retargetvid_tpu_torch.models import dropout
    from retargetvid_tpu_torch.train.trainer import Trainer

    monkeypatch.setattr(torch.backends.cudnn, 'allow_tf32', False)
    monkeypatch.setattr(torch.backends.cuda.matmul, 'allow_tf32', False)
    monkeypatch.setattr(dropout, 'keep_mask', lambda shape, keep, gen: (
        torch.ones(tuple(shape), dtype=torch.bool, device=gen.device)))
    trainers = {d: Trainer(model_cfg=TINY, device=d, steps_per_epoch=2)
                for d in ('cuda', 'cpu')}
    trainers['cpu'].init_state(rng_seed=3)
    # Non-degenerate statistics: see chip_smoke.py:draw_stats.
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for name, buf in trainers['cpu'].model.named_buffers():
            if name.endswith('running_mean'):
                buf.copy_(0.2 * torch.randn(buf.shape, generator=gen))
            elif name.endswith('running_var'):
                buf.copy_(0.5 + torch.rand(buf.shape, generator=gen))
    trainers['cuda'].init_state(
        variables=state_dict_to_flax(trainers['cpu'].model))
    batch = _batch()
    losses = {}
    for d, tr in trainers.items():
        step = tr.step_fn('DHF1K', False, True)
        losses[d] = []
        for _ in range(3):
            tr.state, out = step(tr.state, *(tr._batch(a) for a in batch))
            losses[d].append(float(out['loss']))
    np.testing.assert_allclose(losses['cuda'], losses['cpu'], rtol=1e-4)
    trees = {d: state_dict_to_flax(tr.model) for d, tr in trainers.items()}
    for col in ('params', 'batch_stats'):
        card = dict(_flat(trees['cuda'][col]))
        host = dict(_flat(trees['cpu'][col]))
        diff = np.sqrt(sum(np.sum((card[p] - v) ** 2)
                           for p, v in host.items()))
        norm = np.sqrt(sum(np.sum(v ** 2) for v in host.values()))
        assert diff / norm <= 1e-4, (col, diff / norm)


@pytest.mark.cuda
def test_run_inference_launches_on_the_card():
    _card()
    from retargetvid_tpu_torch.kernels.build import LAUNCHES
    from retargetvid_tpu_torch.train.trainer import Trainer

    tr = Trainer(model_cfg=TINY, device='cuda')
    tr.init_state(rng_seed=3)
    for source, t, want in (('DHF1K', 9, 1), ('SALICON', 70, 3)):
        frames, sal, fix = clip(t=t)
        LAUNCHES.clear()
        maps, scores = tr.run_inference(frames, source=source,
                                        frame_modulo=3, seq_len=2, sal=sal,
                                        fix=fix)
        assert LAUNCHES['saliency_postprocess'] == want, source
        assert maps.shape == frames.shape[:3] and maps.dtype == np.uint8
        assert all(np.isfinite(v) for v in scores.values())
