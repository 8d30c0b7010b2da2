"""The port's ``benchmark`` command vs the JAX CLI's: the sequential loop
and ``--oneshot``, on a folder holding ``001.mp4`` and ``002.mp4`` (48
frames at 72x128, a hard cut at frame 24) with a synthetic 6-annotator
tree.  The same box files, the same ``_info.txt`` keys and non-timing
lines, and the same inline IoU lines.  Models are narrow and float32 on
both sides (the one-shot programs get the JAX models' weights through
``convert``); the port runs on the CPU.
"""

import functools

import pytest
import torch

import jax.numpy as jnp

from test_torch_cli import full_annotation_tree, patch_cli
from test_torch_ingest_stream import Detector, stream_frames, write_mp4
from test_torch_oneshot import models

torch.set_num_threads(1)

FC, H, W = 48, 72, 128


@pytest.fixture(scope='module')
def setup(tmp_path_factory):
    from retargetvid_tpu.models.transnet import TransNetPredictor as JPred
    from retargetvid_tpu.pipeline.saliency import SaliencyPredictor as JSal
    from retargetvid_tpu_torch.models.transnet import TransNetPredictor
    from retargetvid_tpu_torch.pipeline.saliency import SaliencyPredictor

    root = tmp_path_factory.mktemp('bench')
    (root / 'videos').mkdir()
    for i, name in enumerate(('001', '002')):
        write_mp4(root / 'videos' / f'{name}.mp4',
                  stream_frames(FC, H, W, cuts=(24,), seed=i))
    annots = full_annotation_tree(root / 'annots', {1: FC, 2: FC})
    jt, tn_params, ju, un_vars, tn, un = models(f=2, d=16)
    fns = (Detector(JPred(jt, tn_params)),
           JSal(variables=un_vars, model=ju, chunk=8).predict,
           Detector(TransNetPredictor(tn, device='cpu')),
           SaliencyPredictor(un, chunk=8, device='cpu').predict)
    return root, annots, fns, (jt, tn_params, ju, un_vars, tn, un)


def _run(monkeypatch, capsys, setup, extra):
    import retargetvid_tpu.pipeline.oneshot as joneshot
    import retargetvid_tpu_torch.pipeline.oneshot as oneshot

    root, annots, fns, (jt, tn_params, ju, un_vars, tn, un) = setup
    jcli, cli = patch_cli(monkeypatch, fns)
    monkeypatch.setattr(jcli, '_load_oneshot_models',
                        lambda args: (jt, tn_params, un_vars))
    monkeypatch.setattr(cli, '_load_oneshot_models', lambda args: (tn, un))
    monkeypatch.setattr(joneshot, 'OneShotClipProgram', functools.partial(
        joneshot.OneShotClipProgram, model=ju, dtype=jnp.float32))
    monkeypatch.setattr(oneshot, 'OneShotClipProgram', functools.partial(
        oneshot.OneShotClipProgram, dtype=torch.float32))
    out = {}
    name = 'run' + ''.join(extra)
    for side, main, dev in (('jax', jcli.main, []),
                            ('port', cli.main, ['--device', 'cpu'])):
        capsys.readouterr()
        main(['benchmark', '--videos', str(root / 'videos'), '--out',
              str(root / side), '--test-name', name, '--annotations',
              str(annots)] + extra + dev)
        lines = capsys.readouterr().out.splitlines()
        out[side] = (root / side / name,
                     [ln for ln in lines if ln.startswith(('   user #',
                                                           '   mean'))])
    return out


def _info(path):
    pairs = [ln.split(':', 1) for ln in path.read_text().splitlines()
             if ':' in ln]
    return [k for k, _ in pairs], {k: v for k, v in pairs
                                   if not k.startswith('t_')}


@pytest.mark.parametrize('extra', [[], ['--oneshot']],
                         ids=['sequential', 'oneshot'])
def test_benchmark(monkeypatch, capsys, setup, extra):
    out = _run(monkeypatch, capsys, setup, extra)
    (jdir, jious), (pdir, pious) = out['jax'], out['port']
    names = sorted(p.name for p in jdir.iterdir())
    assert names == sorted(p.name for p in pdir.iterdir())
    assert names == sorted(f'{v}_{ar}{s}' for v in ('001', '002')
                           for ar in ('1-3', '3-1')
                           for s in ('.txt', '_info.txt'))
    for name in names:
        if name.endswith('_info.txt'):
            assert _info(pdir / name) == _info(jdir / name), name
        else:
            text = (pdir / name).read_bytes()
            assert text == (jdir / name).read_bytes(), name
            assert text.count(b'\n') == FC
    assert pious == jious
    assert len(pious) == 4 * 7
