"""The port's ``predict`` command and inference datasets vs the JAX
package's.

Both CLIs run on a folder of 5 PNGs and on a 24-frame mp4, static and
``--dynamic --smooth med3``, with the same narrow UNISAL (``TINY_UNISAL_CFG``,
RNN weights drawn from a seed, carried across by ``convert``) patched in
for their model-loading functions; the port runs with ``--device cpu``.  The PNG
maps must match within 1 LSB, the count of differing pixels pinned.
"""

import cv2
import numpy as np
import pytest
import torch

from test_torch_ingest_stream import stream_frames, write_mp4

torch.set_num_threads(1)

N_PNG, FC, H, W = 5, 24, 48, 64
#: Differing pixels per (input, mode) of the written maps; none by more
#: than 1 LSB.
PINNED_DIFF = {('pngs', 'static'): 0, ('pngs', 'dynamic'): 1,
               ('mp4', 'static'): 1, ('mp4', 'dynamic'): 4}


@pytest.fixture(scope='module')
def inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp('predict')
    frames = stream_frames(FC, H, W, cuts=(12,), seed=3)
    (root / 'pngs').mkdir()
    for i in range(N_PNG):
        cv2.imwrite(str(root / 'pngs' / f'img_{i}.png'),
                    cv2.cvtColor(frames[3 * i], cv2.COLOR_RGB2BGR))
    write_mp4(root / 'clip.mp4', frames)
    return root


@pytest.fixture(scope='module')
def models():
    from conftest import TINY_UNISAL_CFG
    from retargetvid_tpu.models.unisal import UNISAL as JUNISAL
    from retargetvid_tpu_torch.convert import load_flax_variables
    from retargetvid_tpu_torch.models.unisal import UNISAL
    from test_torch_unisal_dynamic import tiny_variables

    variables = tiny_variables()
    return (JUNISAL(**TINY_UNISAL_CFG), variables,
            load_flax_variables(UNISAL(**TINY_UNISAL_CFG), variables))


def _patch(monkeypatch, models):
    import retargetvid_tpu.pipeline.saliency as jsaliency
    import retargetvid_tpu.utils.cache as jcache
    import retargetvid_tpu_torch.cli as cli

    ju, weights, un = models
    real = jsaliency.SaliencyPredictor
    # The JAX command passes ``variables=None`` without weight flags.
    monkeypatch.setattr(jsaliency, 'SaliencyPredictor',
                        lambda variables=None, **kw: real(
                            variables=weights, model=ju, **kw))
    monkeypatch.setattr(jcache, 'enable_compilation_cache', lambda: None)
    monkeypatch.setattr(cli, '_load_unisal', lambda args: un)


@pytest.mark.parametrize('kind', ['pngs', 'mp4'])
@pytest.mark.parametrize('mode', ['static', 'dynamic'])
def test_predict_matches_jax(inputs, models, monkeypatch, kind, mode):
    import retargetvid_tpu.cli as jcli
    import retargetvid_tpu_torch.cli as cli

    _patch(monkeypatch, models)
    src = inputs / ('pngs' if kind == 'pngs' else 'clip.mp4')
    extra = ['--chunk', '8']
    if mode == 'dynamic':
        extra += ['--dynamic', '--smooth', 'med3']
    maps = {}
    for side, main, dev in (('jax', jcli.main, []),
                            ('port', cli.main, ['--device', 'cpu'])):
        out = inputs / f'{side}_{kind}_{mode}'
        main(['predict', str(src), '--out', str(out)] + extra + dev)
        files = sorted(out.iterdir())
        maps[side] = ([f.name for f in files],
                      np.stack([cv2.imread(str(f), cv2.IMREAD_UNCHANGED)
                                for f in files]))
    names = maps['port'][0]
    assert names == maps['jax'][0]
    assert names == ([f'img_{i}.png' for i in range(N_PNG)] if kind == 'pngs'
                     else [f'{i:05d}.png' for i in range(FC)])
    got, ref = maps['port'][1], maps['jax'][1]
    assert got.shape == ref.shape == (len(names), H, W)
    diff = np.abs(got.astype(int) - ref.astype(int))
    n_diff = int((diff > 0).sum())
    print(f'predict {kind} {mode}: {n_diff} of {diff.size} pixels differ, '
          f'max {int(diff.max())} LSB')
    assert diff.max() <= 1
    assert n_diff == PINNED_DIFF[(kind, mode)]


def test_predict_needs_a_gpu_unless_asked_for_cpu(inputs, models,
                                                  monkeypatch):
    import retargetvid_tpu_torch.cli as cli

    _patch(monkeypatch, models)
    if torch.cuda.is_available():
        pytest.skip('a GPU is present: the no-GPU contract is moot')
    with pytest.raises(RuntimeError, match='CUDA'):
        cli.main(['predict', str(inputs / 'pngs'), '--out',
                  str(inputs / 'no_gpu')])
    assert not (inputs / 'no_gpu').exists()


def test_datasets_match_jax(inputs):
    """The four inference datasets: the same frames, sizes and
    frame-modulo groups as JAX's, preprocessed within one uint8 step of
    the Lanczos resize (ROADMAP Queue 3)."""
    from retargetvid_tpu.train import data as jdata
    from retargetvid_tpu_torch.train import data

    tol = 1.01 / 255 / 0.225
    pairs = [
        (jdata.FolderImageDataset(inputs / 'pngs'),
         data.FolderImageDataset(inputs / 'pngs', device='cpu')),
        (jdata.FolderVideoDataset(inputs / 'clip.mp4'),
         data.FolderVideoDataset(inputs / 'clip.mp4', device='cpu')),
        (jdata.FolderVideoDataset(inputs / 'pngs', frame_modulo=2),
         data.FolderVideoDataset(inputs / 'pngs', frame_modulo=2,
                                 device='cpu')),
    ]
    for ref, ds in pairs:
        assert len(ds) == len(ref) and ds.frame_modulo == ref.frame_modulo
        assert all(np.array_equal(a, b) for a, b in zip(ds.images,
                                                        ref.images))
        assert ds.out_size_dict == ref.out_size_dict
        np.testing.assert_allclose(ds.get_all_data().numpy(),
                                   ref.get_all_data(), rtol=0, atol=tol)
        got, want = ds.get_data(1), ref.get_data(1)
        assert got[0] == want[0] and tuple(got[2]) == tuple(want[2])
        np.testing.assert_allclose(got[1].numpy(), want[1], rtol=0, atol=tol)
    assert [f.name for f in pairs[0][1].files] == \
        [f.name for f in pairs[0][0].files]
    mem = data.MemoryImageDataset(pairs[0][1].images, device='cpu')
    np.testing.assert_array_equal(mem.get_all_data().numpy(),
                                  pairs[0][1].get_all_data().numpy())
