"""TransNet V2 (``models/transnetv2.py``) against the benchmark's plain
reference (``portbench/reference/transnetv2.py``, the published PyTorch
module): both heads' logits, the published parameter names, the window
plan's per-window band, the one-shot program with V2 against the plain
reference pipeline, the cut threshold read from the model, and the CLI
loading a published-format state dict.

Narrow (F=2, D=16; full width only for the names and shapes) and float32,
with seeded weights; the reference takes the program's state dict.
"""

import functools

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

FC, H, W = 48, 72, 128
SMALL = dict(F=2, D=16)


def seeded_v2(bias, **widths):
    from portbench import inputs
    from retargetvid_tpu_torch.models.transnetv2 import TransNetV2

    model = TransNetV2(**(widths or SMALL))
    return inputs.seed_weights_(model, 3, 1, 'cpu', {'cls_layer1': [bias]})


def reference_of(model):
    from portbench.reference.transnetv2 import TransNetV2 as Ref

    ref = Ref(F=model.F, L=model.L, S=model.S, D=model.D)
    ref.load_state_dict(model.state_dict())
    return ref


def tn_frames(n, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (n, 27, 48, 3), generator=gen,
                         dtype=torch.uint8)


def clip(fc=FC, seed=0):
    """A blob moving over seeded noise, (fc, H, W, 3) uint8."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    base = rng.integers(0, 60, (H, W, 3))
    frames = np.zeros((fc, H, W, 3), np.uint8)
    for t in range(fc):
        cx = W * (0.2 + 0.6 * t / fc)
        blob = 200 * np.exp(-(((yy - H / 2) ** 2 + (xx - cx) ** 2) / 300.0))
        frames[t] = np.clip(base + blob[..., None], 0, 255)
    return torch.from_numpy(frames)


@pytest.fixture(scope='module')
def v2_run(tmp_path_factory):
    """The one-shot program with V2 (head bias -1, float32) on a clip
    written to ``videos/001.mp4`` and decoded back as the CLI decodes it:
    ``raw``, ``out`` (``run``'s outputs), the models and the reference
    UNISAL with the program's weights."""
    import cv2

    from portbench.reference.unisal import UNISAL as RefUNISAL
    from retargetvid_tpu_torch.config import sc_init_crop_params
    from retargetvid_tpu_torch.io.native_reader import open_reader
    from retargetvid_tpu_torch.models.init import seeded_init_
    from retargetvid_tpu_torch.models.unisal import UNISAL
    from retargetvid_tpu_torch.pipeline.oneshot import OneShotClipProgram

    root = tmp_path_factory.mktemp('transnetv2')
    (root / 'videos').mkdir()
    writer = cv2.VideoWriter(str(root / 'videos' / '001.mp4'),
                             cv2.VideoWriter_fourcc(*'mp4v'), 30.0, (W, H))
    assert writer.isOpened(), 'cv2 cannot encode mp4v here'
    for frame in clip().numpy():
        writer.write(np.ascontiguousarray(frame[..., ::-1]))
    writer.release()
    reader = open_reader(root / 'videos' / '001.mp4')
    try:
        raw = torch.from_numpy(np.concatenate(
            [c for c, _ in reader.chunks(256)]))
    finally:
        reader.stop()
    un = seeded_init_(UNISAL(cnn_widen_factor=0.25), 1).eval()
    ref_un = RefUNISAL(cnn_widen_factor=0.25)
    ref_un.load_state_dict(un.state_dict())
    tn = seeded_v2(-1.0)
    cp = sc_init_crop_params()
    prog = OneShotClipProgram(tn, un, dtype=torch.float32, device='cpu')
    out = prog.run(raw, cp, fps=30.0, w_final=24, h_final=72)
    return {'root': root, 'raw': raw, 'cp': cp, 'tn': tn, 'un': un,
            'ref_un': ref_un.eval(), 'out': out}


def test_logits_equal_the_reference_in_float32():
    """Both heads over two 100-frame windows.  The same float32 operations
    in the same order (the band's strided view reads the values of the
    published gather), so 1e-6 leaves room only for a reduction order a
    kernel picks by shape."""
    model = seeded_v2(0.0)
    ref = reference_of(model)
    x = tn_frames(200).view(2, 100, 27, 48, 3)
    with torch.no_grad():
        one_hot, many_hot = model.logits(x)
        r_one, r_many = ref(x)
    assert one_hot.shape == many_hot.shape == (2, 100)
    np.testing.assert_allclose(one_hot, r_one[..., 0], rtol=0, atol=1e-6)
    np.testing.assert_allclose(many_hot, r_many['many_hot'][..., 0],
                               rtol=0, atol=1e-6)
    with torch.no_grad():
        assert torch.equal(model(x), torch.sigmoid(one_hot))


def test_state_dict_has_the_published_names_and_shapes():
    from portbench.reference.transnetv2 import TransNetV2 as Ref
    from retargetvid_tpu_torch.models.transnetv2 import TransNetV2

    state = TransNetV2().state_dict()
    cell = ([f'Conv3D_{d}.layers.{i}.weight' for d in (1, 2, 4, 8)
             for i in (0, 1)]
            + [f'bn.{k}' for k in ('weight', 'bias', 'running_mean',
                                   'running_var', 'num_batches_tracked')])
    names = {f'SDDCNN.{i}.DDCNN.{j}.{k}' for i in range(3) for j in range(2)
             for k in cell}
    names |= {f'{m}.{p}' for m in ('frame_sim_layer.projection',
                                   'frame_sim_layer.fc',
                                   'color_hist_layer.fc', 'fc1',
                                   'cls_layer1', 'cls_layer2')
              for p in ('weight', 'bias')}
    assert set(state) == names and len(state) == 90
    shapes = {'SDDCNN.0.DDCNN.0.Conv3D_1.layers.0.weight': (32, 3, 1, 3, 3),
              'SDDCNN.0.DDCNN.1.Conv3D_8.layers.0.weight': (32, 64, 1, 3, 3),
              'SDDCNN.2.DDCNN.1.Conv3D_8.layers.1.weight': (64, 128, 3, 1, 1),
              'SDDCNN.2.DDCNN.0.bn.running_var': (256,),
              'frame_sim_layer.projection.weight': (128, 448),
              'frame_sim_layer.fc.weight': (128, 101),
              'color_hist_layer.fc.weight': (128, 101),
              'fc1.weight': (1024, 4864), 'cls_layer1.weight': (1, 1024),
              'cls_layer2.bias': (1,)}
    for k, shape in shapes.items():
        assert tuple(state[k].shape) == shape, k
    ref = Ref().state_dict()
    assert {k: v.shape for k, v in ref.items()} == \
        {k: v.shape for k, v in state.items()}
    # A narrow state dict rebuilds its own widths.
    narrow = seeded_v2(0.0).state_dict()
    model = TransNetV2.from_state_dict(narrow)
    assert (model.F, model.L, model.S, model.D) == (2, 3, 2, 16)
    assert all(torch.equal(v, narrow[k])
               for k, v in model.state_dict().items())


def test_window_plan_zero_pads_each_window():
    """A 40-frame clip: the window plan (two windows in one batch) gives
    what one forward over the first window, the clip edge-padded to 100
    frames, gives: neither the band nor a conv reads across windows.
    1e-6: float32 reductions may differ between a batch of two and one."""
    from retargetvid_tpu_torch.models.transnet import window_forward

    model = seeded_v2(0.0)
    frames = tn_frames(40, seed=1)
    src = torch.clamp(torch.arange(100) - 25, 0, 39)
    with torch.no_grad():
        plan = window_forward(model, frames, 40, 40)
        one = model(frames[src][None])[0, 25:65]
    assert plan.shape == (40,)
    np.testing.assert_allclose(plan, one, rtol=0, atol=1e-6)


def test_oneshot_program_equals_the_reference_pipeline(v2_run):
    """``OneShotClipProgram`` with V2 (window plan, float32) against the
    plain reference pipeline: the same picks, scenes and boxes."""
    from portbench.reference.pipeline import dest_size
    from portbench.reference.pipeline_transnetv2 import crop_clip

    out = v2_run['out']
    assert dest_size(W, H, '1:3') == (24, 72)
    ref = crop_clip(reference_of(v2_run['tn']), v2_run['ref_un'],
                    v2_run['raw'], v2_run['cp'], fps=30.0, ratios=['1:3'],
                    un_input_dtype=torch.float32)
    n_sel, n_seg = out['fc_sel'], out['n_segments']
    assert (n_sel, n_seg) == (ref['fc_sel'], ref['n_segments']) == (9, 1)
    assert np.array_equal(out['sel_idx'][:n_sel], ref['sel_idx'])
    assert np.array_equal(out['seg_starts'][:n_seg], ref['seg_starts'])
    assert np.array_equal(out['seg_ends'][:n_seg], ref['seg_ends'])
    assert np.array_equal(out['boxes'], ref['boxes'][0])


def test_threshold_is_read_from_the_model(v2_run):
    """V2 cuts above 0.5 on every path.  With the head's bias at -1 every
    probability lies between V1's 0.1 and V2's 0.5: the one-shot body and
    the host-side sampling of the two-dispatch path take every 6th frame
    and one shot, where V1's threshold would cut at every frame; at +1
    every probability is above 0.5 and the host side picks every frame."""
    from retargetvid_tpu_torch.config import TRANS_THRESHOLD
    from retargetvid_tpu_torch.models.transnet import (
        TransNetPredictor,
        TransNetV1,
        cut_threshold,
    )
    from retargetvid_tpu_torch.pipeline.ingest import segment_chunks

    assert cut_threshold(TransNetV1(f=2, d=16)) == TRANS_THRESHOLD == 0.1
    assert cut_threshold(lambda frames: frames) == 0.1
    out = v2_run['out']
    probs = out['probs'][:FC]
    assert ((probs > 0.1) & (probs < 0.5)).all()
    assert (out['fc_sel'], out['n_segments']) == (9, 1)
    info = {'fps': 30.0, 'frame_count': FC, 'width': W, 'height': H}

    def no_maps(frames):
        return torch.zeros(frames.shape[:3], dtype=torch.uint8)

    picked = {}
    for bias in (-1.0, 1.0):
        tn = seeded_v2(bias)
        predictor = TransNetPredictor(tn, device='cpu')
        assert cut_threshold(tn) == cut_threshold(predictor) == 0.5
        vd = segment_chunks(info, [(v2_run['raw'], 0)], v2_run['cp'],
                            predictor, no_maps, device='cpu')
        picked[bias] = vd['true_inds']
    assert picked[-1.0] == list(range(0, FC, 6)) + [FC - 1]
    assert picked[1.0] == list(range(FC))


def test_cli_loads_a_published_format_state_dict(v2_run, monkeypatch):
    """``benchmark --oneshot --transnet-arch v2 --transnet-weights`` on a
    state dict saved from the seeded V2 writes the boxes that model gives
    in the program directly."""
    import retargetvid_tpu_torch.cli as cli
    import retargetvid_tpu_torch.pipeline.oneshot as oneshot

    root = v2_run['root']
    weights = root / 'transnetv2-pytorch-weights.pth'
    torch.save(v2_run['tn'].state_dict(), weights)
    monkeypatch.setattr(cli, '_load_unisal', lambda args: v2_run['un'])
    monkeypatch.setattr(oneshot, 'OneShotClipProgram', functools.partial(
        oneshot.OneShotClipProgram, dtype=torch.float32))
    cli.main(['benchmark', '--oneshot', '--videos', str(root / 'videos'),
              '--out', str(root / 'out'), '--ratios', '1:3', '--device',
              'cpu', '--transnet-arch', 'v2', '--transnet-weights',
              str(weights)])
    got = np.loadtxt(root / 'out' / 'default_config' / '001_1-3.txt',
                     delimiter=',', ndmin=2)
    assert got.shape == (FC, 4)
    assert np.array_equal(got, v2_run['out']['boxes'])
