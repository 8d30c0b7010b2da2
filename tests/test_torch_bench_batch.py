"""The bench's two-dispatch and batch modes against the port's own
programs.

``run_bench`` at 48-frame 72x128 clips, float32, ``iters=2``, with
``test_torch_bench_modes.py``'s seeded tiny models: the two-dispatch mode
gives the outputs of its steps through ``FusedClipProgram`` (a one-cut
probability profile drives sampling, as in ``bench.py``), and
``BENCH_BATCH=2`` the picks, shots and boxes of the single-clip program.
The ``cuda`` case runs the batch mode at full width on the card:
``python -m pytest tests/test_torch_bench_batch.py -m cuda --noconftest``.
"""

import numpy as np
import pytest
import torch

from test_torch_bench_modes import H, N, W, _clips, _equal, _run, _setup

torch.set_num_threads(1)


def test_two_dispatch_mode():
    from retargetvid_tpu_torch.ops.scenes import (
        fix_scene_bounds,
        predictions_to_scenes,
        scenes_to_selected,
    )
    from retargetvid_tpu_torch.pipeline.fused import FusedClipProgram
    from retargetvid_tpu_torch.pipeline.ingest import (
        TRANS_THRESHOLD,
        _resize_kernel,
        sal_dims,
        sample_frames,
    )

    result, outs, (_, un) = _run(oneshot=False, pipeline='1')
    # No pipelined protocol on this path: per-clip only, windowed.
    assert result['protocol'] == 'per_clip_median'
    assert result['tn_plan'] == 'windowed'
    assert 'pipelined_fps' not in result
    cp, dests = _setup()
    probs = np.zeros(N, np.float32)
    probs[N // 2] = 1.0
    selected, true_inds, m2o = sample_frames(N, probs, cp['skip'], N)
    seg = fix_scene_bounds(predictions_to_scenes(probs, TRANS_THRESHOLD), N)
    resize = _resize_kernel(H, W, *sal_dims(W, H, cp['max_input_d']))
    fused = FusedClipProgram(un, dtype=torch.float32, device='cpu')
    for clip, out in zip(_clips((0, 1)), outs['per_clip']):
        _, sal = resize(torch.from_numpy(clip))
        want = fused.run(sal, selected, true_inds, seg,
                         scenes_to_selected(seg, m2o), cp, fps=30.0,
                         h_orig=H, w_orig=W, w_final=dests[0][0],
                         h_final=dests[0][1], fc=N)
        _equal(out, want)
    assert len(seg) == 2


def test_batch_mode():
    """``BENCH_BATCH=2`` on a gloo group of one: each iteration is a
    sliding window of 2 over the pool, each clip with the picks, shots,
    probabilities and boxes of the single-clip program."""
    import torch.distributed as dist

    from retargetvid_tpu_torch.pipeline.oneshot import OneShotClipProgram

    result, outs, models = _run(batch=2)
    assert not dist.is_initialized()
    assert result['protocol'] == 'per_clip_median'
    assert 'pipelined_fps' not in result
    cp, dests = _setup()
    kw = dict(fps=30.0, w_final=dests[0][0], h_final=dests[0][1])
    pool = _clips((0, 1, 2))
    single = OneShotClipProgram(*models, dtype=torch.float32,
                                tn_fullseq=True, device='cpu')
    assert len(outs['per_clip']) == 2
    for i, batch in enumerate(outs['per_clip']):
        assert len(batch) == 2
        for got, clip in zip(batch, pool[i:i + 2]):
            one = single.run(clip, cp, **kw)
            assert not got['overrun']
            assert (got['fc_sel'], got['n_segments']) == \
                (one['fc_sel'], one['n_segments'])
            np.testing.assert_allclose(got['probs'][:N], one['probs'][:N],
                                       rtol=0, atol=1e-5)
            np.testing.assert_array_equal(got['boxes'], one['boxes'])


@pytest.mark.cuda
def test_batch_mode_on_the_card():
    """At full width on the card (bf16, full-sequence plan): each clip of a
    ``BENCH_BATCH=2`` batch has the picks, shots and boxes of
    ``OneShotClipProgram.run`` on the same clip and weights, and the kernel
    launches once per clip."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA GPU (run on the card: python -m pytest '
                    'tests/test_torch_bench_batch.py -m cuda --noconftest)')
    from retargetvid_tpu_torch.bench import build_models, make_clip, run_bench
    from retargetvid_tpu_torch.kernels.build import LAUNCHES
    from retargetvid_tpu_torch.pipeline.oneshot import OneShotClipProgram

    tn, un = build_models()
    LAUNCHES.clear()
    result, outs = run_bench(tn, un, iters=1, batch=2)
    assert LAUNCHES['saliency_postprocess'] == 4    # warm-up batch + 1
    assert result['per_clip_fps'] > 0
    assert result['device'] == torch.cuda.get_device_name(0) or \
        result['device'].startswith(torch.cuda.get_device_name(0))
    cp, dests = _setup(640, 360)
    program = OneShotClipProgram(tn, un, tn_fullseq=True)
    for seed, got in zip((0, 1), outs['per_clip'][0]):
        clip = torch.from_numpy(make_clip(seed=seed)).cuda()
        want = program.run(clip, cp, fps=30.0, w_final=dests[0][0],
                           h_final=dests[0][1])
        assert (got['fc_sel'], got['n_segments']) == \
            (want['fc_sel'], want['n_segments'])
        np.testing.assert_array_equal(got['boxes'], want['boxes'])
