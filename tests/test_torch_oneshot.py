"""The slice as a whole: the port's OneShotClipProgram vs the JAX one.

Both run float32, the full-sequence TransNet plan, fc=48 at 72x128, the
narrow UNISAL of ``conftest.TINY_UNISAL_CFG`` and a full-width TransNet
whose head is biased (``dense2.bias = [5, -5]``) so sampling runs its
every-skip regime; the port's weights are the JAX ones carried across by
``convert``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

FC, H, W = 48, 72, 128


def clip_frames(fc=FC):
    """The fc=48, 72x128 clip of ``tests/test_oneshot.py`` (or its
    ``fc``-frame version): a blob that moves, then stops on a brighter
    background."""
    yy, xx = np.mgrid[0:H, 0:W]
    frames = np.zeros((fc, H, W, 3), np.uint8)
    for t in range(fc):
        cx = W * (0.2 + 0.6 * t / fc) if t < fc // 2 else W * 0.75
        blob = 225 * np.exp(-(((yy - H * 0.5) ** 2 + (xx - cx) ** 2)
                              / 250.0))
        frames[t] = np.clip(blob[..., None] + (10 if t < fc // 2 else 60),
                            0, 255).astype(np.uint8)
    return frames


def models(**tn_cfg):
    """Seeded JAX TransNet (``tn_cfg`` its widths; head biased to
    ``[5, -5]``) and ``TINY_UNISAL_CFG`` UNISAL, and the port's modules
    holding the same weights: (jt, tn_params, ju, un_vars, tn, un)."""
    from conftest import TINY_UNISAL_CFG
    from retargetvid_tpu.models.transnet import TransNetV1 as JTransNet
    from retargetvid_tpu.models.unisal import UNISAL as JUNISAL
    from retargetvid_tpu_torch.convert import load_flax_variables
    from retargetvid_tpu_torch.models.transnet import TransNetV1
    from retargetvid_tpu_torch.models.unisal import UNISAL

    jt = JTransNet(**tn_cfg)
    tn_params = jax.tree_util.tree_map(np.asarray, jt.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 27, 48, 3), jnp.uint8)))
    tn_params['params']['dense2']['bias'] = np.asarray([5.0, -5.0],
                                                       np.float32)
    ju = JUNISAL(**TINY_UNISAL_CFG)
    un_vars = jax.tree_util.tree_map(np.asarray, ju.init(
        jax.random.PRNGKey(1), jnp.zeros((1, 1, 224, 416, 3), jnp.float32),
        static=True))
    tn = load_flax_variables(TransNetV1(**tn_cfg), tn_params)
    un = load_flax_variables(UNISAL(**TINY_UNISAL_CFG), un_vars,
                             skip=('rnn', 'post_rnn'))
    return jt, tn_params, ju, un_vars, tn, un


@pytest.fixture(scope='module')
def runs():
    from retargetvid_tpu.config import sc_init_crop_params
    from retargetvid_tpu.ops.boxes import calc_dest_size
    from retargetvid_tpu.pipeline.oneshot import OneShotClipProgram as JProg
    from retargetvid_tpu_torch.pipeline.oneshot import OneShotClipProgram

    cp = sc_init_crop_params()
    cp['out_ratio'] = '1:3'
    dest = calc_dest_size(W, H, cp['out_ratio'])
    kw = dict(fps=30.0, w_final=dest['w_final'], h_final=dest['h_final'])
    frames = clip_frames()
    jt, tn_params, ju, un_vars, tn, un = models()
    ref = JProg(jt, tn_params, variables=un_vars, model=ju,
                dtype=jnp.float32, tn_fullseq=True).run(
        jnp.asarray(frames), cp, **kw)
    out = OneShotClipProgram(tn, un, dtype=torch.float32, tn_fullseq=True,
                             device='cpu').run(frames, cp, **kw)
    return ref, out, (ju, un_vars, un, frames, cp)


def test_integer_structure_exact(runs):
    ref, out, _ = runs
    assert out['fc_sel'] == ref['fc_sel'] > 0
    assert out['n_segments'] == ref['n_segments']
    for k in ('sel_idx', 'seg_starts', 'seg_ends'):
        assert np.array_equal(np.asarray(out[k], np.int64),
                              np.asarray(ref[k], np.int64)), k


def test_probs(runs):
    ref, out, _ = runs
    err = np.abs(out['probs'][:FC] - ref['probs'][:FC]).max()
    print(f'probs: max |diff| {err:.3g} (atol 1e-5)')
    np.testing.assert_allclose(out['probs'][:FC], ref['probs'][:FC],
                               rtol=0, atol=1e-5)


def saliency_maps(ju, un_vars, un, frames, sel):
    """Each side's uint8 saliency maps of the frames ``sel`` of ``frames``,
    from its own ingest resize, preprocess, UNISAL and postprocess."""
    from retargetvid_tpu.ops.resize import resize as jresize
    from retargetvid_tpu.ops.resize import round_half_up as jrhu
    from retargetvid_tpu.pipeline.ingest import sal_dims
    from retargetvid_tpu.pipeline.saliency import (
        get_optimal_out_size,
        preprocess_frames as jpre,
    )
    from retargetvid_tpu_torch.kernels.postprocess import saliency_postprocess
    from retargetvid_tpu_torch.ops.resize import resize, round_half_up
    from retargetvid_tpu_torch.pipeline.saliency import preprocess_frames

    sal_hw = sal_dims(frames.shape[2], frames.shape[1], 250)
    net_hw = get_optimal_out_size(sal_hw)
    sel = np.asarray(sel, np.int64)

    def jfn(v, x):
        sal = jnp.clip(jrhu(jresize(x, sal_hw, 'linear')), 0, 255)
        xin = jpre(sal.astype(jnp.uint8)[sel], net_hw)
        logp, _ = ju.apply(v, xin[:, None], target_size=sal_hw,
                           source='SALICON', static=True)
        p = jnp.exp(logp[:, 0, :, :, 0])
        mx = jnp.max(p, axis=(1, 2), keepdims=True)
        return (jnp.where(mx > 0, p / mx, p) * 255.0).astype(jnp.uint8)

    jmaps = np.asarray(jax.jit(jfn)(un_vars, jnp.asarray(frames)))
    with torch.no_grad():
        sal = torch.clamp(round_half_up(resize(
            torch.from_numpy(frames), sal_hw, 'linear', channels_last=True)),
            0, 255).to(torch.uint8)
        logp = un(preprocess_frames(sal[torch.from_numpy(sel)],
                                    net_hw)[:, None], target_size=sal_hw,
                  source='SALICON')
        tmaps = saliency_postprocess(logp[:, 0, :, :, 0].contiguous())
    return jmaps, tmaps.numpy()


def test_boxes(runs):
    """Within 1 px; exactly equal when the uint8 saliency maps are."""
    ref, out, (ju, un_vars, un, frames, _) = runs
    jmaps, tmaps = saliency_maps(ju, un_vars, un, frames,
                                 ref['sel_idx'][:ref['fc_sel']])
    map_diff = np.abs(jmaps.astype(int) - tmaps.astype(int))
    box_err = int(np.abs(out['boxes'] - ref['boxes']).max())
    print(f'saliency maps: {int((map_diff > 0).sum())} of {map_diff.size} '
          f'uint8 pixels differ, max {map_diff.max()} LSB')
    print(f'boxes: max |diff| {box_err} px (tolerance 1 px; 0 where the '
          f'maps are equal), {int((out["boxes"] != ref["boxes"]).any(1).sum())}'
          f' of {FC} frames differ')
    assert out['boxes'].shape == ref['boxes'].shape == (FC, 4)
    assert box_err <= 1
    if map_diff.max() == 0:
        assert box_err == 0


def test_series(runs):
    ref, out, _ = runs
    for k, n in (('dx', ref['fc_sel']), ('dy', ref['fc_sel']),
                 ('dxs', FC), ('dys', FC)):
        err = np.abs(out[k][:n] - ref[k][:n]).max()
        print(f'{k}: max |diff| {err:.3g} (atol 1e-2)')
        np.testing.assert_allclose(out[k][:n], ref[k][:n], rtol=0, atol=1e-2)


def test_static_bound_overrun_raises(runs):
    """A clip with more cuts than s_pad is refused by collect()."""
    from retargetvid_tpu_torch.pipeline.oneshot import OneShotClipProgram

    _, _, (_, _, un, frames, cp) = runs
    tn = _AlwaysCut()
    prog = OneShotClipProgram(tn, un, dtype=torch.float32, tn_fullseq=True,
                              device='cpu')
    with pytest.raises(ValueError, match='static bounds'):
        prog.run(frames, cp, fps=30.0, w_final=24, h_final=72)


class _AlwaysCut(torch.nn.Module):
    """A TransNet stand-in that calls every other frame a transition."""

    def forward(self, frames):
        t = frames.shape[1]
        probs = torch.zeros((1, t))
        probs[:, ::2] = 0.9
        return probs
