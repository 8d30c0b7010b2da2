"""CPU runs of ``crop-ism-single`` (path ``crop_focus``): the jump clips,
the head rule on UNISAL's adaptation conv, the focus freeze firing and
judged against the reference, the faults that must come out as not
correct, the control, and the cell's entries in BENCHMARK.json with their
readers.

The freeze needs the published widths and 640x360 frames (the narrow
UNISAL of the other CPU tests gives maps on which no span freezes), so
those runs cut only the clip's length: 120 frames, the jump over frames
48-71, float32 everywhere.

    python -m pytest portbench -q
"""

import json
import time

import pytest
import torch

from portbench import core, inputs
from portbench.check import tf32
from portbench.paths import crop_focus, crop_oneshot
from portbench.reference import pipeline as ref
from portbench.test_portbench_cpu import FLOAT32, ROOT, SMALL, SMALL_MODELS

torch.set_num_threads(2)
CELL = 'crop-ism-single'
JUMP = {'frames': [48, 72], 'shift': 0.35}
#: 120 frames give 21 picks, which the program and the reference pad to
#: the same bucket (32), as the cell's 480 frames do (96): the mean
#: saliency is taken over the padded picks on both sides.
SHORT = {'frames': 120, 'height': 360, 'width': 640, 'pool': 1,
         'check_clips': 1, 'jump': JUMP}


def run_cell(traffic, config=None, control=False, seed=2147483901):
    return core.run(CELL, seed, 0.01, False, t_process=time.perf_counter(),
                    device='cpu', control=control,
                    overrides={'traffic': traffic, 'config': config})


def test_jump_clips_move_the_blob_only_inside_the_jump():
    """Outside the jump frames the clips are ``inputs.clip_pool``'s bit for
    bit (the same noise draws, the same formula); inside, the blob's
    centre lies ``shift`` x width to the right: the formula again, with
    the noise drawn from the same generator."""
    n, fc, h, w, seed = 2, 40, 72, 128, 2147483901
    jump = {'frames': [10, 20], 'shift': 0.35}
    got = crop_focus.clip_pool(n, fc, h, w, seed, 'cpu', jump)
    plain = inputs.clip_pool(n, fc, h, w, seed, 'cpu')
    assert all(torch.equal(a, b) for a, b in zip(
        crop_focus.clip_pool(n, fc, h, w, seed, 'cpu'), plain))
    outside = [t for t in range(fc) if not 10 <= t < 20]
    gen = torch.Generator().manual_seed(inputs._mix(seed, 7))
    t = torch.arange(fc, dtype=torch.float32)
    lin = t / (fc - 1)
    cx = w * (0.2 + 0.6 * lin) + 0.35 * w
    cy = h * (0.5 + 0.2 * torch.sin(8.0 * lin))
    yy, xx = (torch.arange(s, dtype=torch.float32) for s in (h, w))
    blob = 200.0 * torch.exp(-((yy[None, :, None] - cy[:, None, None]) ** 2
                               + (xx[None, None, :] - cx[:, None, None]) ** 2)
                             / 2500.0)
    for clip, base in zip(got, plain):
        assert clip.shape == (fc, h, w, 3) and clip.dtype == torch.uint8
        assert torch.equal(clip[outside], base[outside])
        noise = torch.randint(0, 60, (h, w, 3), generator=gen)
        moved = torch.clamp(noise.float()[None] + blob[..., None], 0,
                            255).to(torch.uint8)
        assert torch.equal(clip[10:20], moved[10:20])
        assert not torch.equal(clip[10:20], base[10:20])


def test_head_rule_sets_the_share_and_one_state():
    """After the head rule the float32 reference's uint8 maps leave at most
    ``salient_share`` of any rule frame's pixels above ``t_threshold``, and
    exactly that on the sharpest one, so the rule's scale read again is 1
    (within 1e-5 relative: the weight rounds once to float32); its
    direction is the discriminant of the features, which the weight does
    not feed.  The program, the reference and the control load one state:
    the seeded one with only the adaptation weight set."""
    _, _, cfg, traffic = core.load_cell(CELL)
    cfg = core.merged(cfg, SMALL_MODELS)
    traffic = core.merged(traffic, SMALL)
    seed = 2147483901
    ad = crop_focus.Adapter(cfg, traffic, seed, torch.device('cpu'))
    plain = crop_oneshot.Adapter(cfg, traffic, seed, torch.device('cpu'))
    plain.release()
    state = inputs.state_of(ad.program.un_model)
    assert state.keys() == ad.un_state.keys() == plain.un_state.keys()
    for k, v in state.items():
        assert torch.equal(v, ad.un_state[k]), k
        if k == 'adaptation_salicon.weight':
            assert torch.equal(v.flatten(), ad.head.float())
            assert not torch.equal(v, plain.un_state[k])
        else:
            assert torch.equal(v, plain.un_state[k]), k
    clip = ad.make_pool(1)[0]
    ad.release()
    un = crop_oneshot.RefUNISAL(
        cnn_widen_factor=cfg['unisal']['cnn_widen_factor'])
    un.load_state_dict(ad.un_state)
    with tf32(False):
        feats, logp, idx = crop_focus.head_inputs(
            un.eval(), clip, cfg['crop_params']['max_input_d'])
    share = cfg['unisal']['salient_share']
    t = cfg['crop_params']['t_threshold']
    assert crop_focus.head_scale(logp, share, t) == pytest.approx(
        1.0, rel=1e-5)
    above = (ref.postprocess(logp.float()) > t).flatten(1).double().mean(1)
    assert float(above.max()) <= share + 2 / above.numel()
    direction = crop_focus.head_direction(
        feats, idx, (SMALL['height'], SMALL['width']), traffic['jump'])
    cos = torch.nn.functional.cosine_similarity(direction, ad.head, dim=0)
    assert float(cos) == pytest.approx(1.0, abs=1e-6)


def test_short_clip_freezes_and_agrees_with_the_reference(monkeypatch):
    """The subject's jump away and back freezes a span (``no_freeze`` 0 on
    the checked clip); scenes, maps and the geometry, the focus scores and
    the freeze included, equal the reference's."""
    readings = []
    load = core.load_module

    def load_recording(kind, name):
        mod = load(kind, name)
        if (kind, name) == ('paths', 'crop_focus'):
            compare = mod.Adapter.compare

            def recorded(self, got, expect):
                readings.append(compare(self, got, expect))
                return readings[-1]
            monkeypatch.setattr(mod.Adapter, 'compare', recorded)
        return mod
    monkeypatch.setattr(core, 'load_module', load_recording)
    res = run_cell(SHORT, FLOAT32)
    values = {k: c['value'] for k, c in res['checks'].items()}
    assert values == {'scene_mismatch': 0.0, 'map_gap_ratio': 0.0,
                      'geometry_mismatch': 0.0, 'no_freeze': 0.0}
    assert res['correct'] is True
    assert res['attempted'] >= 1 and res['failed'] == 0
    assert readings and all(r['no_freeze'] == 0 for r in readings)


def _freeze_off(monkeypatch):
    """The program's freeze returns the centres unchanged."""
    from retargetvid_tpu_torch.pipeline import geometry
    monkeypatch.setattr(geometry, 'freeze_unstable_segments',
                        lambda cx, cy, *args, **kwargs: (cx, cy))


def _scores_altered(monkeypatch, step=1):
    """The program's focus scores read ``step`` higher: one step changes
    no pick's jump decision, so only the scores themselves show it; 255
    lifts every score above ``foces_stab_t``, so nothing freezes."""
    from retargetvid_tpu_torch.pipeline import geometry
    inner = geometry.jump_saliency_scores
    monkeypatch.setattr(geometry, 'jump_saliency_scores',
                        lambda *args, **kwargs: inner(*args, **kwargs) + step)


def _scores_lifted(monkeypatch):
    _scores_altered(monkeypatch, step=255)


def _shift_boxes(monkeypatch):
    from retargetvid_tpu_torch.pipeline import fused
    inner = fused.geometry_boxes

    def altered(*args, **kwargs):
        out = inner(*args, **kwargs)
        out['boxes'] = out['boxes'] + 1
        return out
    monkeypatch.setattr(fused, 'geometry_boxes', altered)


@pytest.mark.parametrize('fault,no_freeze', [
    (_freeze_off, 0), (_scores_altered, 0), (_scores_lifted, 1),
    (_shift_boxes, 0)],
    ids=['freeze_off', 'scores_altered', 'scores_lifted', 'boxes_shifted'])
def test_an_answer_altered_where_it_is_produced_is_not_correct(
        fault, no_freeze, monkeypatch):
    fault(monkeypatch)
    res = run_cell(SHORT, FLOAT32)
    assert res['correct'] is False
    c = res['checks']['geometry_mismatch']
    assert c['value'] > c['limit']
    assert res['checks']['no_freeze']['value'] == no_freeze


def test_control_reads_farther_than_the_program():
    res = run_cell({**SMALL, 'jump': {'frames': [12, 24], 'shift': 0.35}},
                   SMALL_MODELS, control=True)
    c = res['checks']['map_gap_ratio']
    assert c['control'] > c['value']


def test_cell_resolves_and_its_readers_read_a_record():
    spec = json.loads((ROOT / 'BENCHMARK.json').read_text())
    _, cell, cfg, traffic = core.load_cell(CELL, spec)
    assert (cell['config'], cell['chips']) == ('smartvidcrop-ism2021', 1)
    assert traffic['path'] == 'crop_focus' and traffic['jump'] == {
        'frames': [240, 264], 'shift': 0.35}
    assert cfg['limits'].keys() == {'scene_mismatch', 'map_gap_ratio',
                                    'geometry_mismatch', 'no_freeze'}
    e2e = core.metric_names(spec, CELL, 'end_to_end')
    assert e2e == ['frames_per_s', 'clip_ms_p50', 'clip_ms_p90', 'setup_s']
    layer = core.metric_names(spec, CELL, 'per_layer')
    stages = {name: [2.0, 4.0] for name in (
        'transnet', 'unisal', 'geometry.cluster', 'geometry.redo',
        'geometry.interpolate', 'geometry.lowpass', 'geometry.loess')}
    stages.update(geometry=[20.0, 24.0], ccl_sweeps=[9, 11],
                  redo_frames=[2, 2], dispatch_syncs=[60, 62],
                  bn_act=[64, 64], saliency_smooth=[1, 1])
    rec = {'clip_ms': [50.0, 60.0], 'dispatch_ms': [40.0, 44.0],
           'stages': stages, 'clips': 2, 'window_s': 1.0, 'in_flight': 1,
           'model_flops': [(989e9, 'bfloat16'), (495e9, 'tf32')],
           'postprocess_bytes': 3350000,
           'profile': {'busy_s': 0.05, 'window_s': 0.2, 'clips': 2,
                       'launches': 3000,
                       'kernels': {'void saliency_postprocess_kernel<true>'
                                   '(float const*)': (2e-5, 2)}}}
    got = {m: core.load_module('metrics', m).read(rec) for m in layer}
    assert None not in got.values(), got
    # Per clip the stage less its five children: 20 - 10 and 24 - 20.
    assert got['geometry_self_ms'] == 7.0
    assert got['loess_ms'] == 3.0               # Savitzky-Golay under ISM
    assert got['ccl_sweeps_per_clip'] == 10
    # The geometry chain's spans and counters are read in the V2 cell too.
    v2 = core.metric_names(spec, 'crop-transnetv2-single', 'per_layer')
    assert {'cluster_ms', 'redo_ms', 'interpolate_ms', 'lowpass_ms',
            'loess_ms', 'geometry_self_ms', 'ccl_sweeps_per_clip',
            'redo_frames_per_clip', 'dispatch_syncs_per_clip'} <= set(v2)
