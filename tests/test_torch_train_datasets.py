"""Port vs JAX: the training datasets on synthetic trees written with cv2.

The trees are those of ``tests/test_train_datasets.py`` and
``tests/test_train_fit.py:39-98`` (DHF1K, Hollywood, UCF Sports, SALICON
with a raw ``.mat`` fixation file, MIT1003, MIT300), and a generic
per-video folder tree.  Splits, sample plans,
file names, sizes and ``ImgSizeBatchSampler``'s batches equal JAX's; both
packages draw their random samples from ``default_rng(seed)``, so a batch
of one equals the other's within the resize tolerances pinned in ROADMAP
Queue 3: frames (Lanczos, PIL rounding) at most one uint8 step apart on at
most 0.01% of values, saliency targets within 1e-4 relative (+1e-9
absolute), fixations exact.
"""

import shutil

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip('cv2')

torch.set_num_threads(1)

#: One uint8 step of a normalized frame value (the smallest ImageNet std).
FRAME_STEP = 1.0 / 255 / 0.224 + 1e-6
FRAME_SHARE = 1e-4


def _png(path, arr):
    path.parent.mkdir(parents=True, exist_ok=True)
    cv2.imwrite(str(path), arr)


def _frame(rng, hw=(64, 64), ch=3):
    shape = (*hw, ch) if ch else hw
    return rng.integers(0, 255, shape).astype(np.uint8)


def assert_batches_close(got, ref, label):
    """(x, sal, fix) of the port (tensors) against JAX's (numpy)."""
    x, sal, fix = (np.asarray(g.cpu().numpy() if torch.is_tensor(g) else g)
                   for g in got)
    rx, rsal, rfix = (np.asarray(r) for r in ref)
    assert x.shape == rx.shape and sal.shape == rsal.shape, label
    dx = np.abs(x - rx)
    assert dx.max() <= FRAME_STEP, (label, dx.max())
    assert (dx > 1e-5).mean() <= FRAME_SHARE, (label, (dx > 1e-5).mean())
    np.testing.assert_allclose(sal, rsal, rtol=1e-4, atol=1e-9,
                               err_msg=label)
    np.testing.assert_array_equal(fix, rfix, err_msg=label)
    return float(dx.max()), float(np.abs(sal - rsal).max())


@pytest.fixture()
def dhf1k_tree(tmp_path):
    rng = np.random.default_rng(0)
    for v in range(1, 7):
        vdir = tmp_path / 'annotation' / f'{v:04d}'
        for f in range(1, 13):
            _png(vdir / 'images' / f'{f:04d}.png', _frame(rng))
            _png(vdir / 'maps' / f'{f:04d}.png', _frame(rng, ch=0))
            _png(vdir / 'fixation' / f'{f:04d}.png',
                 (rng.random((64, 64)) > 0.97).astype(np.uint8) * 255)
    return tmp_path


def test_dhf1k_split_plan_and_batches(dhf1k_tree, monkeypatch):
    from retargetvid_tpu.train.data import DHF1KDataset as J
    from retargetvid_tpu_torch.train.data import DHF1KDataset as T

    monkeypatch.setenv('DHF1K_DATA_DIR', str(dhf1k_tree))
    kw = dict(seq_len=3, frame_modulo=2, val_size=2)
    for phase in ('train', 'valid'):
        j, t = J(phase=phase, **kw), T(phase=phase, device='cpu', **kw)
        assert t.vid_nr_array == j.vid_nr_array
        assert t.n_images_dict == j.n_images_dict
        assert t.samples == j.samples
        assert t.data_file(t.vid_nr_array[0], 3, 'fix') == \
            j.data_file(j.vid_nr_array[0], 3, 'fix')
        errs = assert_batches_close(t.sample(2), j.sample(2), phase)
        print(f'DHF1K {phase}: frames {errs[0]:.3g}, saliency {errs[1]:.3g}')
    # The defaults: 12 x 5 windows on a 224x384 grid.
    t = T(phase='train', device='cpu')
    assert (t.seq_len, t.frame_modulo, t.out_size) == (12, 5, (224, 384))


@pytest.fixture()
def hollywood_tree(tmp_path):
    rng = np.random.default_rng(1)
    root = tmp_path / 'training'
    for vid in (1, 2):
        for shot in (1, 2):
            d = root / f'actionclip{"train"}{vid:05d}_{shot:1d}'
            for f in range(3, 15):      # starts at frame 3 (register path)
                stem = f'actionclip{"train"}{vid:05d}_{f:05d}.png'
                _png(d / 'images' / stem, _frame(rng))
                _png(d / 'maps' / stem, _frame(rng, ch=0))
                _png(d / 'fixation' / stem, _frame(rng, ch=0))
    return tmp_path


def test_hollywood_register_and_batches(hollywood_tree, monkeypatch):
    from retargetvid_tpu.train.data import HollywoodDataset as J
    from retargetvid_tpu_torch.train.data import HollywoodDataset as T

    monkeypatch.setenv('HOLLYWOOD_DATA_DIR', str(hollywood_tree))
    kw = dict(seq_len=3, frame_modulo=2, val_size=1)
    j, t = J(phase='train', **kw), T(phase='train', device='cpu', **kw)
    assert t._register == j._register
    assert t.n_images_dict == j.n_images_dict and t.samples == j.samples
    key = next(iter(t.n_images_dict))
    assert t.data_file(key, 1, 'frame') == j.data_file(key, 1, 'frame')
    assert_batches_close(t.sample(1), j.sample(1), 'hollywood')


@pytest.fixture()
def ucf_tree(tmp_path):
    rng = np.random.default_rng(2)
    root = tmp_path / 'training'
    for name in ('Diving-Side-001', 'Golf-Swing-Back-002', 'Kicking-003'):
        d = root / name
        for f in range(12):
            stem = f'{name}_{f:03d}'
            _png(d / 'images' / f'{stem}.png', _frame(rng))
            _png(d / 'maps' / f'{stem}.png', _frame(rng, ch=0))
            _png(d / 'fixation' / f'{stem}.png', _frame(rng, ch=0))
    return tmp_path


def test_ucfsports_names_and_batches(ucf_tree, monkeypatch):
    from retargetvid_tpu.train.data import UCFSportsDataset as J
    from retargetvid_tpu_torch.train.data import UCFSportsDataset as T

    monkeypatch.setenv('UCFSPORTS_DATA_DIR', str(ucf_tree))
    kw = dict(seq_len=3, frame_modulo=2, val_size=1)
    for phase in ('train', 'valid'):
        j, t = J(phase=phase, **kw), T(phase=phase, device='cpu', **kw)
        assert t.vid_nr_array == j.vid_nr_array and t.samples == j.samples
        v = t.vid_nr_array[0]
        assert t.data_file(v, 2, 'sal') == j.data_file(v, 2, 'sal')
        assert_batches_close(t.sample(1), j.sample(1), f'ucf {phase}')


@pytest.fixture()
def salicon_tree(tmp_path):
    """Three COCO images with maps; image 21's fixations only as the raw
    ``.mat`` (resolution + per-subject gaze points, 1-based x, y)."""
    import scipy.io
    rng = np.random.default_rng(3)
    for nr in (7, 13, 21):
        stem = f'COCO_train2014_{nr:012d}'
        _png(tmp_path / 'images' / f'{stem}.jpg', _frame(rng))
        _png(tmp_path / 'maps' / 'train' / f'{stem}.png', _frame(rng, ch=0))
        if nr != 21:
            _png(tmp_path / 'fixations' / 'train' / f'{stem}.png',
                 _frame(rng, ch=0))
    gaze = np.zeros((2, 1), dtype=[('location', 'O'), ('timestamp', 'O'),
                                   ('fixations', 'O')])
    for i in range(2):
        gaze[i, 0]['location'] = np.zeros((1, 2))
        gaze[i, 0]['timestamp'] = np.zeros((1, 1))
        gaze[i, 0]['fixations'] = rng.integers(1, 65, (5, 2))
    scipy.io.savemat(str(tmp_path / 'fixations' / 'train' /
                         'COCO_train2014_000000000021.mat'),
                     {'resolution': np.array([[64, 64]]), 'gaze': gaze})
    return tmp_path


def test_salicon_naming_mat_fixations_and_batches(salicon_tree, tmp_path,
                                                  monkeypatch):
    from retargetvid_tpu.train.data import SALICONDataset as J
    from retargetvid_tpu_torch.train.data import SALICONDataset as T

    jtree = tmp_path / 'jax_copy'
    shutil.copytree(salicon_tree, jtree, ignore=shutil.ignore_patterns(
        'jax_copy'))
    monkeypatch.setenv('SALICON_DATA_DIR', str(salicon_tree))
    t = T(phase='train', device='cpu')
    j = J(phase='train', data_dir=str(jtree))
    assert t.samples == j.samples == [7, 13, 21]
    fix = t.get_fixation_map(21)
    np.testing.assert_array_equal(fix, j.get_fixation_map(21))
    assert fix.shape == (64, 64) and 0 < (fix == 255).sum() <= 10
    for nr in (7, 21):
        got, ref = t.get_data(nr), j.get_data(nr)
        assert got[4] == ref[4] == (480, 640)
        assert_batches_close(got[1:4], ref[1:4], f'salicon {nr}')
        assert abs(float(got[2].sum()) - 1.0) < 1e-4
    x, sal, fix = t.sample(2)
    assert x.shape == (2, 1, 288, 384, 3)
    assert_batches_close((x, sal, fix), j.sample(2), 'salicon sample')


@pytest.fixture()
def mit_trees(tmp_path):
    rng = np.random.default_rng(0)
    img_dir = tmp_path / 'mit1003' / 'ALLSTIMULI' / 'ALLSTIMULI'
    fix_dir = tmp_path / 'mit1003' / 'ALLFIXATIONMAPS' / 'ALLFIXATIONMAPS'
    shapes = [(96, 128), (128, 96), (96, 128), (100, 140), (128, 96),
              (96, 128), (100, 140), (128, 96), (96, 128), (96, 128)]
    for i, (h, w) in enumerate(shapes):
        stem = f'i{i:03d}'
        _png(img_dir / f'{stem}.jpeg',
             rng.integers(0, 255, (h, w, 3)).astype(np.uint8))
        _png(fix_dir / f'{stem}_fixMap.jpg',
             rng.integers(0, 255, (h, w)).astype(np.uint8))
        _png(fix_dir / f'{stem}_fixPts.jpg',
             (rng.random((h, w)) > 0.99).astype(np.uint8) * 255)
    d = tmp_path / 'mit300' / 'BenchmarkIMAGES'
    for i in (1, 2, 10):
        _png(d / f'i{i}.jpg', rng.integers(0, 255, (80, 120, 3)).astype(
            np.uint8))
    return tmp_path


def test_mit1003_split_sizes_sampler_and_batches(mit_trees, monkeypatch):
    from retargetvid_tpu.train.data import ImgSizeBatchSampler as JS
    from retargetvid_tpu.train.data import MIT1003Dataset as J
    from retargetvid_tpu_torch.train.data import ImgSizeBatchSampler as TS
    from retargetvid_tpu_torch.train.data import MIT1003Dataset as T

    monkeypatch.setenv('MIT1003_DATA_DIR', str(mit_trees / 'mit1003'))
    for phase, kw in (('train', dict(n_x_val=5, x_val_step=0)),
                      ('valid', dict(n_x_val=5, x_val_step=0)),
                      ('train', dict(x_val_step=None)),
                      ('test', dict(x_val_step=None))):
        j, t = J(phase=phase, **kw), T(phase=phase, device='cpu', **kw)
        assert t.samples == j.samples and t.size_dict == j.size_dict
        assert t.target_size_dict == j.target_size_dict
        got, ref = t.get_data(t.samples[0]), j.get_data(j.samples[0])
        assert got[4] == ref[4]
        assert_batches_close(got[1:4], ref[1:4], f'mit1003 {phase}')
    for bs in (1, 2, 3):
        assert list(TS(t, batch_size=bs)) == list(JS(j, batch_size=bs))
        assert len(TS(t, batch_size=bs)) == len(JS(j, batch_size=bs))
    for got, ref in zip(t.batches(2, shuffle=False),
                        j.batches(2, shuffle=False)):
        assert_batches_close(got, ref, 'mit1003 batches')
        assert got[0].shape[1] == 1


def test_mit300(mit_trees, monkeypatch):
    from retargetvid_tpu.train.data import MIT300Dataset as J
    from retargetvid_tpu_torch.train.data import MIT300Dataset as T

    monkeypatch.setenv('MIT300_DATA_DIR', str(mit_trees / 'mit300'))
    j, t = J(), T(device='cpu')
    assert t.samples == j.samples
    assert [s[0] for s in t.samples] == ['i1.jpg', 'i2.jpg', 'i10.jpg']
    for i in range(3):
        got, ref = t.get_data(i), j.get_data(i)
        assert got[2] == ref[2] == (80, 120)
        dx = np.abs(got[1].numpy() - np.asarray(ref[1]))
        assert dx.max() <= FRAME_STEP and (dx > 1e-5).mean() <= FRAME_SHARE


def test_generic_folder_dataset(tmp_path):
    """``_SaliencyFolderDataset``: per-video ``images``/``maps``/
    ``fixation`` folders, random windows from ``default_rng(seed)``."""
    from retargetvid_tpu.train.data import _SaliencyFolderDataset as J
    from retargetvid_tpu_torch.train.data import _SaliencyFolderDataset as T

    rng = np.random.default_rng(5)
    for v in range(2):
        for f in range(8):
            for sub, ch in (('images', 3), ('maps', 3), ('fixation', 3)):
                _png(tmp_path / f'v{v}' / sub / f'{f:03d}.png',
                     _frame(rng, hw=(48, 80), ch=ch))
    kw = dict(data_dir=str(tmp_path), seq_len=3, seed=2)
    t, j = T(device='cpu', **kw), J(**kw)
    assert t.videos == j.videos
    for _ in range(2):
        assert_batches_close(t.sample(2), j.sample(2), 'folder')


def test_missing_data_dir_raises(monkeypatch):
    from retargetvid_tpu_torch.train import data

    for name, var in (('DHF1KDataset', 'DHF1K_DATA_DIR'),
                      ('SALICONDataset', 'SALICON_DATA_DIR'),
                      ('MIT1003Dataset', 'MIT1003_DATA_DIR')):
        monkeypatch.delenv(var, raising=False)
        with pytest.raises(FileNotFoundError, match=var):
            getattr(data, name)(device='cpu')
