"""The bench's one-shot modes against the port's own programs.

``run_bench`` at 48-frame 72x128 clips, float32, ``iters=2``, with the tiny
TransNet (f=2, l=3, s=2, d=16, head biased) and the narrow UNISAL, seeded:
the windowed and multi-ratio modes give, clip for clip, the outputs of
``OneShotClipProgram.run`` and ``dispatch_multi`` in the same process (each
of which has its JAX parity tests).  The two-dispatch and batch modes:
``test_torch_bench_batch.py``.
"""

import numpy as np
import torch

torch.set_num_threads(1)

N, H, W = 48, 72, 128


def _models():
    from retargetvid_tpu_torch.dryrun import TINY_UNISAL
    from retargetvid_tpu_torch.models.init import seeded_init_
    from retargetvid_tpu_torch.models.transnet import TransNetV1
    from retargetvid_tpu_torch.models.unisal import UNISAL

    tn = seeded_init_(TransNetV1(f=2, l=3, s=2, d=16), 0)
    with torch.no_grad():
        tn.dense2.bias.copy_(torch.tensor([5.0, -5.0]))
    return tn, seeded_init_(UNISAL(**TINY_UNISAL), 1)


def _setup(w=W, h=H):
    from retargetvid_tpu_torch.config import sc_init_crop_params
    from retargetvid_tpu_torch.ops.boxes import calc_dest_size

    cp = sc_init_crop_params()
    cp['out_ratio'] = '1:3'
    dests = [calc_dest_size(w, h, r) for r in ('1:3', '3:1')]
    return cp, [(d['w_final'], d['h_final']) for d in dests]


def _clips(seeds, n=N, h=H, w=W):
    from retargetvid_tpu_torch.bench import make_clip
    return [make_clip(n, h, w, s) for s in seeds]


def _equal(got, want):
    assert got.keys() == want.keys()
    for key in got:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def _run(**kw):
    from retargetvid_tpu_torch.bench import run_bench
    tn, un = _models()
    result, outs = run_bench(tn, un, n_frames=N, h=H, w=W, iters=2,
                             dtype=torch.float32, device='cpu', **kw)
    return result, outs, (tn, un)


def test_windowed_mode():
    from retargetvid_tpu_torch.pipeline.oneshot import OneShotClipProgram

    result, outs, models = _run(tn_fullseq=False)
    assert (result['tn_plan'], result['ratios_per_dispatch']) == \
        ('windowed', 1)
    cp, dests = _setup()
    program = OneShotClipProgram(*models, dtype=torch.float32, device='cpu')
    got = outs['per_clip'] + outs['pipelined']
    for clip, out in zip(_clips((0, 1, 200, 201)), got):
        _equal(out, program.run(clip, cp, fps=30.0, w_final=dests[0][0],
                                h_final=dests[0][1]))


def test_multi_ratio_mode():
    from retargetvid_tpu_torch.pipeline.oneshot import OneShotClipProgram

    result, outs, models = _run(multi_ratio=True, pipeline='0')
    assert result['ratios_per_dispatch'] == 2
    assert 'pipelined_fps' not in result and not outs['pipelined']
    cp, dests = _setup()
    program = OneShotClipProgram(*models, dtype=torch.float32,
                                 tn_fullseq=True, device='cpu')
    for clip, out in zip(_clips((0, 1)), outs['per_clip']):
        want = program.collect_multi(program.dispatch_multi(
            clip, cp, fps=30.0, dests=dests))
        assert len(out) == 2
        for a, b in zip(out, want):
            _equal(a, b)
        assert not np.array_equal(out[0]['boxes'], out[1]['boxes'])
