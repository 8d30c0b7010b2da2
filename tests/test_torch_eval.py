"""The RetargetVid evaluator: the port's ``eval`` package vs the JAX
package's on a synthetic 6-annotator tree over a few videos (annotations
shipped as zips, two result runs: one whole with timing ``_info.txt``
files, one with a missing, a short and an off-by-two file).  Scores and
the text written are equal, byte for byte."""

import zipfile

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

VIDS = (1, 2, 601)
ARS = ('1-3', '3-1')
N_FRAMES = {1: 12, 2: 9, 601: 15}


def _boxes(rng, n, ar):
    if ar == '1-3':
        x = rng.integers(-5, 520, n)
        return np.stack([x, np.zeros(n, int), x + 120, np.full(n, 360)], 1)
    y = rng.integers(-5, 146, n)
    return np.stack([np.zeros(n, int), y, np.full(n, 640), y + 214], 1)


def _write(path, boxes):
    from retargetvid_tpu_torch.eval.annotations import write_boxes_file
    write_boxes_file(path, boxes)


def make_annotations(root, vids=VIDS, n_frames=N_FRAMES, seed=0):
    """annotator_{1..6}.zip under ``root``, each holding
    ``annotator_k/NNN_<ar>.txt``; returns the ground truth."""
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    gt = {}
    for k in range(1, 7):
        with zipfile.ZipFile(root / f'annotator_{k}.zip', 'w') as zf:
            for v in vids:
                for ar in ARS:
                    b = _boxes(rng, n_frames[v], ar)
                    gt[(k, ar, v)] = b
                    zf.writestr(f'annotator_{k}/{v:03d}_{ar}.txt',
                                ''.join('%d,%d,%d,%d\n' % tuple(r)
                                        for r in b))
    return gt


def make_results(root, seed=1):
    rng = np.random.default_rng(seed)
    whole = root / 'run_whole'
    broken = root / 'run_broken'
    whole.mkdir(parents=True)
    broken.mkdir(parents=True)
    for v in VIDS:
        for ar in ARS:
            b = _boxes(rng, N_FRAMES[v], ar)
            _write(whole / f'{v:03d}_{ar}.txt', b)
            with open(whole / f'{v:03d}_{ar}_info.txt', 'w') as fp:
                t = rng.uniform(0.1, 3.0)
                fp.write(f'result:smart cropped\ncuts_clust:{v % 3}\n'
                         f"t__read:{'%7.3fs, %6.3f%%' % (t, t * 9)}\n"
                         f"t__clustering:{'%7.3fs, %6.3f%%' % (t, t * 4)}\n"
                         f"t_total:{'%7.3fs, %6.3f%%' % (t, t * 13)}\n")
            if (v, ar) == (1, '1-3'):
                continue                              # missing file
            if (v, ar) == (2, '3-1'):
                b = b[:5]                             # short file
            if (v, ar) == (601, '1-3'):
                b = np.concatenate([b, b[:2]])        # two frames too many
            _write(broken / f'{v:03d}_{ar}.txt', b)


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp('eval')
    gt = make_annotations(root / 'annotations')
    make_results(root / 'results')
    return root, gt


def _annots(root, side, tag):
    if side == 'port':
        from retargetvid_tpu_torch.eval.annotations import load_annotations
    else:
        from retargetvid_tpu.eval.annotations import load_annotations
    return load_annotations(root / 'annotations', vid_inds=VIDS,
                            extract_to=root / f'extract_{tag}')


def test_load_annotations_from_zips(tree):
    root, gt = tree
    got, ref = _annots(root, 'port', 'a'), _annots(root, 'jax', 'b')
    assert (root / 'extract_a' / 'annotator_6' / '601_3-1.txt').is_file()
    assert not (root / 'annotations' / 'annotator_1').exists()
    assert len(got) == len(ref) == 6
    for k in range(6):
        for ar in ARS:
            for v in VIDS:
                assert np.array_equal(got[k][ar][v], ref[k][ar][v])
                assert np.array_equal(got[k][ar][v], gt[(k + 1, ar, v)])


def test_boxes_file_roundtrip(tmp_path):
    from retargetvid_tpu.eval.annotations import (
        read_boxes_file as jread,
        write_boxes_file as jwrite,
    )
    from retargetvid_tpu_torch.eval.annotations import (
        read_boxes_file,
        write_boxes_file,
    )

    b = _boxes(np.random.default_rng(3), 17, '1-3')
    write_boxes_file(tmp_path / 'port.txt', b)
    jwrite(tmp_path / 'jax.txt', b)
    assert (tmp_path / 'port.txt').read_bytes() == \
        (tmp_path / 'jax.txt').read_bytes()
    assert np.array_equal(read_boxes_file(tmp_path / 'jax.txt'), b)
    assert np.array_equal(jread(tmp_path / 'port.txt'), b)


def test_iou_and_benchmark_boxes():
    from retargetvid_tpu.eval import harness as jh
    from retargetvid_tpu_torch.eval import harness

    rng = np.random.default_rng(4)
    a = rng.integers(-20, 600, (3, 50, 4))
    b = rng.integers(-20, 600, (50, 4))
    a[..., 2:] = a[..., :2] + rng.integers(0, 200, (3, 50, 2))
    b[..., 2:] = b[..., :2] + rng.integers(0, 200, (50, 2))
    assert np.array_equal(harness.iou_xyxy_inclusive(a, b),
                          jh.iou_xyxy_inclusive(a, b))
    assert np.array_equal(harness.iou_series(a[0], b),
                          jh.iou_series(a[0], b))
    for ar in ('1:3', '1-3', '3:1', '3-1'):
        assert np.array_equal(harness.benchmark_eval_boxes(b, ar),
                              jh.benchmark_eval_boxes(b, ar))
    with pytest.raises(ValueError, match='aspect ratio'):
        harness.benchmark_eval_boxes(b, '4:5')


def test_evaluate_results_tree(tree, capsys):
    """Scores, stats, validity and the printed and written text."""
    from retargetvid_tpu.eval import harness as jh
    from retargetvid_tpu_torch.eval import harness

    root, _ = tree
    annots = _annots(root, 'port', 'c')
    results = root / 'results'
    capsys.readouterr()
    got = harness.evaluate_results_tree(results, annots, root / 'port.txt',
                                        vid_inds=VIDS)
    out_port = capsys.readouterr().out
    ref = jh.evaluate_results_tree(results, annots, root / 'jax.txt',
                                   vid_inds=VIDS)
    out_jax = capsys.readouterr().out
    assert out_port == out_jax
    assert 'could not find annotation!' in out_port
    text = (root / 'port.txt').read_bytes()
    assert text == (root / 'jax.txt').read_bytes()
    assert text.count(b'\n') == 3
    assert sorted(got) == sorted(ref) == ['run_broken', 'run_whole']
    for run in got:
        assert got[run]['validity'] == ref[run]['validity']
        assert got[run]['info_stats'] == ref[run]['info_stats']
        for ar in ARS:
            for k in ('worst', 'best', 'mean', 'per_user',
                      'missing_files'):
                assert got[run][ar][k] == ref[run][ar][k], (run, ar, k)
    assert got['run_broken']['validity'] == (1, 2)
    assert harness.validate_runs(results, annots, VIDS, verbose=False) == \
        jh.validate_runs(results, annots, VIDS, verbose=False)
    assert harness.parse_info_stats(results / 'run_whole', VIDS) == \
        jh.parse_info_stats(results / 'run_whole', VIDS)


def test_timing_registry():
    """The ``<sec>s, <percent>%`` strings and the ``_``-key roll-up into
    ``total`` equal JAX's; ``stage_timer`` accumulates."""
    from retargetvid_tpu.utils import timing as jtiming
    from retargetvid_tpu_torch.utils import timing

    times = {'read_init': 0.01234, '_read': 1.5, '_read_shot_det': 0.25,
             '_clustering': 12.3456789, 'render': 0.5}
    out = {}
    for name, mod in (('port', timing), ('jax', jtiming)):
        mod.sc_init_time()
        for k, v in times.items():
            mod.sc_save_time_override(k, v)
        mod.sc_register_time(0.0, '_read')             # a huge interval
        mod.sc_save_time_override('_read', 1.5)
        out[name] = mod.sc_all_times(3.2)
        assert mod.sc_get_time('_clustering') == times['_clustering']
    assert out['port'] == out['jax']
    assert out['port']['total'] == '%7.3fs, %6.3f%%' % (
        14.0956789, 14.0956789 / 3.2 * 100)
    with timing.stage_timer('_border_det', device='cpu'):
        pass
    with timing.stage_timer('_border_det'):
        pass
    assert 0 <= timing.sc_get_time('_border_det') < 1.0
    assert list(timing.sc_times()) == list(times) + ['_border_det']
