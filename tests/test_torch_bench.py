"""The port's throughput bench against the JAX package, on the CPU.

``retargetvid_tpu_torch.bench.run_bench`` in its default mode (the one-shot
program, full-sequence TransNet plan, both protocols) on 48-frame 72x128
``make_clip`` clips, float32, ``iters=2``, with the tiny TransNet (f=2, l=3,
s=2, d=16, head biased) and ``TINY_UNISAL_CFG`` UNISAL, the port's weights
the JAX ones through ``convert``: every timed clip's boxes against JAX's
``OneShotClipProgram.run`` on the same clip, within 1 px and apart only
where the uint8 saliency maps differ (``tests/test_torch_oneshot.py``'s
bound).  The other modes: ``test_torch_bench_modes.py``.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_oneshot import models, saliency_maps

torch.set_num_threads(1)

N, H, W = 48, 72, 128
REPO = Path(__file__).resolve().parent.parent


def bench_py_keys():
    """The keys of the JSON line of the JAX package's ``bench.py``."""
    tree = ast.parse((REPO / 'bench.py').read_text())
    keys = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and node.targets and isinstance(
                node.targets[0], ast.Name) and node.targets[0].id == 'result':
            keys |= {k.value for k in node.value.keys}
        if isinstance(node, ast.Subscript) and isinstance(
                node.value, ast.Name) and node.value.id == 'result' and \
                isinstance(node.slice, ast.Constant):
            keys.add(node.slice.value)
    return keys


@pytest.fixture(scope='module')
def runs():
    from retargetvid_tpu.config import sc_init_crop_params
    from retargetvid_tpu.ops.boxes import calc_dest_size
    from retargetvid_tpu.pipeline.oneshot import OneShotClipProgram as JProg
    from retargetvid_tpu_torch.bench import make_clip, run_bench

    jt, tn_params, ju, un_vars, tn, un = models(f=2, l=3, s=2, d=16)
    result, outs = run_bench(tn, un, n_frames=N, h=H, w=W, iters=2,
                             dtype=torch.float32, device='cpu')
    cp = sc_init_crop_params()
    cp['out_ratio'] = '1:3'
    dest = calc_dest_size(W, H, '1:3')
    ref = JProg(jt, tn_params, variables=un_vars, model=ju,
                dtype=jnp.float32, tn_fullseq=True)
    clips, refs = {}, {}
    for seed in (0, 1, 200, 201):
        clips[seed] = make_clip(N, H, W, seed)
        refs[seed] = ref.run(jnp.asarray(clips[seed]), cp, fps=30.0,
                             w_final=dest['w_final'], h_final=dest['h_final'])
    return dict(result=result, outs=outs, clips=clips, refs=refs,
                jax=(ju, un_vars), un=un)


def test_make_clip_is_bench_pys():
    import importlib.util

    from retargetvid_tpu_torch.bench import make_clip

    spec = importlib.util.spec_from_file_location('bench', REPO / 'bench.py')
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)

    np.testing.assert_array_equal(make_clip(N, H, W, 3),
                                  bench.make_clip(N, H, W, seed=3))


def test_default_mode_matches_jax(runs):
    ju, un_vars = runs['jax']
    got = runs['outs']['per_clip'] + runs['outs']['pipelined']
    assert len(got) == 4
    for seed, out in zip((0, 1, 200, 201), got):
        ref = runs['refs'][seed]
        assert (out['fc_sel'], out['n_segments']) == \
            (int(ref['fc_sel']), int(ref['n_segments']))
        np.testing.assert_allclose(out['probs'][:N], ref['probs'][:N],
                                   rtol=0, atol=1e-5)
        assert out['boxes'].shape == (N, 4)
        box_err = int(np.abs(out['boxes'] - ref['boxes']).max())
        print(f'seed {seed}: {out["fc_sel"]} picks, boxes max |diff| '
              f'{box_err} px')
        assert box_err <= 1
        if box_err:
            jmaps, tmaps = saliency_maps(ju, un_vars, runs['un'],
                                         runs['clips'][seed],
                                         out['sel_idx'][:out['fc_sel']])
            assert (jmaps != tmaps).any()


def test_result_has_bench_pys_keys(runs):
    keys = bench_py_keys()
    assert {'metric', 'value', 'per_clip_fps', 'pipelined_fps',
            'tn_plan'} <= keys
    res = runs['result']
    assert keys | {'device', 'allow_tf32'} == set(res)
    assert res['protocol'] == 'per_clip_median'
    assert res['tn_plan'] == 'fullseq'
    assert res['ratios_per_dispatch'] == 1
    assert res['device'] == 'cpu'
    assert res['value'] == res['per_clip_fps'] > 0
    assert res['pipelined_fps'] > 0
    assert res['vs_baseline'] == res['value'] / (30.0 / 0.19)


def test_main_needs_a_gpu():
    from retargetvid_tpu_torch import bench

    if torch.cuda.is_available():
        pytest.skip('a GPU is present: the no-GPU contract is moot')
    with pytest.raises(RuntimeError, match='CUDA'):
        bench.main()
