"""Port vs JAX: the saliency training losses.

``kld_loss``, ``nss``, ``corr_coeff`` and ``loss_sequences`` on seeded
(B, T, H, W, 1) maps, with an empty fixation map (NSS scores 1.0) and
zero-valued targets (0*log(0) = 0 in the KL divergence); tolerance 1e-6
absolute on values of order 1.  The composite loss's gradient with
respect to the log-probabilities is compared too.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

ATOL = 1e-6
B, T, H, W = 2, 3, 24, 40


def maps(seed=0):
    """(log-probabilities, saliency target, fixations); frame (0, 1) has
    no fixation, frame (1, 2)'s target is zero on half the map."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 2, (B, T, H * W))
    logp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    sal = rng.random((B, T, H * W)) ** 3
    sal[1, 2, : H * W // 2] = 0.0
    sal /= sal.sum(-1, keepdims=True)
    fix = (rng.random((B, T, H * W)) > 0.97).astype(np.float32)
    fix[0, 1] = 0.0
    shape = (B, T, H, W, 1)
    return tuple(a.reshape(shape).astype(np.float32)
                 for a in (logp, sal, fix))


@pytest.mark.parametrize('name', ['kld_loss', 'nss', 'corr_coeff'])
def test_loss_matches_jax(name):
    from retargetvid_tpu.train import losses as jl
    from retargetvid_tpu_torch.train import losses as tl

    logp, sal, fix = maps()
    pred = np.exp(logp)
    args = {'kld_loss': (logp, sal), 'nss': (pred, fix),
            'corr_coeff': (pred, sal)}[name]
    ref = np.asarray(getattr(jl, name)(*map(jnp.asarray, args)))
    out = getattr(tl, name)(*map(torch.from_numpy, args)).numpy()
    assert out.shape == ref.shape == (B, T)
    print(f'{name}: max |diff| {np.abs(out - ref).max():.3g}')
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)
    if name == 'nss':
        assert out[0, 1] == ref[0, 1] == 1.0
    if name == 'kld_loss':
        assert np.isfinite(out).all()


@pytest.mark.parametrize('metrics', [('kld', 'nss', 'cc'), ('kld',)])
def test_loss_sequences_and_gradient_match_jax(metrics):
    """Each summand, and the gradient of ``kld - 0.1 nss - 0.1 cc`` (the
    trainer's loss) with respect to the log-probabilities."""
    from retargetvid_tpu.train.losses import loss_sequences as jls
    from retargetvid_tpu_torch.train.losses import loss_sequences as tls

    logp, sal, fix = maps(seed=1)
    weights = (1.0, -0.1, -0.1)[:len(metrics)]

    def jloss(lp):
        parts = jls(lp, jnp.asarray(sal), jnp.asarray(fix), metrics)
        return sum(w * jnp.mean(p) for w, p in zip(weights, parts)), parts

    (jval, jparts), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(logp))
    lp = torch.from_numpy(logp).requires_grad_(True)
    parts = tls(lp, torch.from_numpy(sal), torch.from_numpy(fix), metrics)
    val = sum(w * torch.mean(p) for w, p in zip(weights, parts))
    val.backward()
    for ref, got in zip(jparts, parts):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                                   rtol=0, atol=ATOL)
    assert abs(float(val.detach()) - float(jval)) <= ATOL
    gerr = float(np.abs(lp.grad.numpy() - np.asarray(jgrad)).max())
    print(f'loss_sequences {metrics}: gradient max |diff| {gerr:.3g}')
    np.testing.assert_allclose(lp.grad.numpy(), np.asarray(jgrad), rtol=0,
                               atol=ATOL)


def test_unknown_metric_raises():
    from retargetvid_tpu_torch.train.losses import loss_sequences

    logp, sal, fix = (torch.from_numpy(a) for a in maps())
    with pytest.raises(ValueError, match='unknown metric'):
        loss_sequences(logp, sal, fix, ('kld', 'auc'))
