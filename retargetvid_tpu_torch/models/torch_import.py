"""Reference UNISAL checkpoints -> the port's UNISAL.

Port of ``retargetvid_tpu/models/torch_import.py``.  The reference's torch
``state_dict`` layouts -- ``weights_best.pth`` (``unisal/train.py:1203``,
``unisal/model.py:32-33``) and the ImageNet ``mobilenet_v2.pth.tar``
(``unisal/models/MobileNetV2.py:154-157``) -- are first converted, in
numpy, into the JAX package's ``{'params', 'batch_stats'}`` tree, which
``convert.load_flax_variables`` then carries into the module, so one
name map serves both packages.  Layout rules of the tree:

- conv weights (O, I, kh, kw) -> HWIO (kh, kw, I, O);
- depthwise conv (C, 1, kh, kw) -> (kh, kw, 1, C);
- BatchNorm weight/bias/running_mean/running_var -> scale/bias/mean/var;
- DomainBN keeps one BN per source under ``bn_<source>``;
- GRU affine scales (C, 1, 1) flatten to (C,);
- the 41x41 smoothing kernels become their rank-r SVD factors.
"""

from __future__ import annotations

import warnings
from typing import Dict, Tuple

import numpy as np

from retargetvid_tpu_torch.convert import load_flax_variables
from retargetvid_tpu_torch.models.mobilenet_v2 import INVERTED_RESIDUAL_SETTING
from retargetvid_tpu_torch.models.unisal import factorize_smoothing_kernel

__all__ = ["convert_unisal_state_dict", "load_unisal_state_dict", "SOURCES"]

SOURCES = ('DHF1K', 'Hollywood', 'UCFSports', 'SALICON')

# torch nn.Sequential index layout inside InvertedResidual.conv
_INVRES_EXPAND = (('pw', 0), ('pw_bn', 1), ('dw', 3), ('dw_bn', 4),
                  ('pw_linear', 6), ('pw_linear_bn', 7))
_INVRES_NOEXPAND = (('dw', 0), ('dw_bn', 1), ('pw_linear', 3),
                    ('pw_linear_bn', 4))


def _conv_w(w) -> np.ndarray:
    return np.asarray(w).transpose(2, 3, 1, 0)


class _TreeWriter:
    """Accumulates (path -> array) assignments into nested dicts."""

    def __init__(self):
        self.params: Dict = {}
        self.stats: Dict = {}
        self.consumed: set = set()

    def put(self, tree, path, value):
        node = tree
        parts = path.split('/')
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(value)

    def conv(self, sd, tpre, fpre, bias=False):
        self.params_entry(f'{fpre}/kernel', _conv_w(sd[f'{tpre}.weight']))
        self.consumed.add(f'{tpre}.weight')
        if bias:
            self.params_entry(f'{fpre}/bias', sd[f'{tpre}.bias'])
            self.consumed.add(f'{tpre}.bias')

    def bn(self, sd, tpre, fpre):
        self.params_entry(f'{fpre}/scale', sd[f'{tpre}.weight'])
        self.params_entry(f'{fpre}/bias', sd[f'{tpre}.bias'])
        self.stats_entry(f'{fpre}/mean', sd[f'{tpre}.running_mean'])
        self.stats_entry(f'{fpre}/var', sd[f'{tpre}.running_var'])
        for suf in ('weight', 'bias', 'running_mean', 'running_var',
                    'num_batches_tracked'):
            self.consumed.add(f'{tpre}.{suf}')

    def dsbn(self, sd, tpre, fpre):
        for src in SOURCES:
            self.bn(sd, f'{tpre}.bn_{src}', f'{fpre}/bn_{src.lower()}')

    def params_entry(self, path, value):
        self.put(self.params, path, value)

    def stats_entry(self, path, value):
        self.put(self.stats, path, value)


def _invres(w: _TreeWriter, sd, tpre, fpre, expand: bool, ds_bn: bool):
    layout = _INVRES_EXPAND if expand else _INVRES_NOEXPAND
    for name, idx in layout:
        key = f'{tpre}.{idx}'
        if name.endswith('_bn'):
            if ds_bn:
                w.dsbn(sd, key, f'{fpre}/{name}')
            else:
                w.bn(sd, key, f'{fpre}/{name}')
        else:
            w.conv(sd, key, f'{fpre}/{name}')


def _mobilenet(w: _TreeWriter, sd, tpre='cnn', fpre='cnn'):
    w.conv(sd, f'{tpre}.features.0.0', f'{fpre}/features_0/conv')
    w.bn(sd, f'{tpre}.features.0.1', f'{fpre}/features_0/bn')
    idx = 1
    for t, _, n, _ in INVERTED_RESIDUAL_SETTING:
        for _ in range(n):
            _invres(w, sd, f'{tpre}.features.{idx}.conv',
                    f'{fpre}/features_{idx}', expand=(t != 1), ds_bn=False)
            idx += 1
    if f'{tpre}.features.{idx}.0.weight' in sd:
        w.conv(sd, f'{tpre}.features.{idx}.0', f'{fpre}/features_{idx}/conv')
        w.bn(sd, f'{tpre}.features.{idx}.1', f'{fpre}/features_{idx}/bn')


def _mobile_gru_conv(w: _TreeWriter, sd, tpre, fpre):
    w.conv(sd, f'{tpre}.conv_dw', f'{fpre}/conv_dw')
    w.dsbn(sd, f'{tpre}.sep_bn', f'{fpre}/sep_bn')
    w.conv(sd, f'{tpre}.conv_sep', f'{fpre}/conv_sep')


def convert_unisal_state_dict(sd, smoothing_rank=8) -> Tuple[dict, dict, list]:
    """Convert a reference UNISAL state_dict into the JAX tree layout.

    ``smoothing_rank``: factorize the smoothing kernels into rank-r SVD
    factors (None keeps the full kernel).  Returns (params, batch_stats,
    unconsumed_keys).
    """
    sd = {k: np.asarray(v) for k, v in sd.items()}
    w = _TreeWriter()

    _mobilenet(w, sd)

    # Per-source modules use LOWERCASED torch key names (the reference builds
    # them from f'_{source}'.lower(), model.py:250), unlike DSBN's bn_<Source>.
    for src in SOURCES:
        lo = src.lower()
        if f'coarse_gaussians_{lo}' in sd:
            w.params_entry(f'coarse_gaussians_{lo}',
                           sd[f'coarse_gaussians_{lo}'])
            w.consumed.add(f'coarse_gaussians_{lo}')
        w.conv(sd, f'adaptation_{lo}.0', f'adaptation_{lo}', bias=True)
        sm = sd[f'smoothing_{lo}.weight']
        if smoothing_rank:
            k2d = np.asarray(_conv_w(sm))[:, :, 0, 0]
            kv, kh, trunc = factorize_smoothing_kernel(k2d, smoothing_rank)
            if trunc > 1e-4:
                print(f' note: smoothing_{lo} SVD rank-{smoothing_rank} '
                      f'truncation {trunc:.2e}')
            # The factors in the tree's HWIO layout: (k,1,1,r), (1,k,r,1).
            w.params_entry(f'smoothing_v_{lo}', kv.transpose(2, 3, 1, 0))
            w.params_entry(f'smoothing_h_{lo}', kh.transpose(2, 3, 1, 0))
        else:
            w.params_entry(f'smoothing_{lo}', _conv_w(sm))
        w.consumed.add(f'smoothing_{lo}.weight')

    _invres(w, sd, 'post_cnn.inv_res.conv', 'post_cnn',
            expand=False, ds_bn=False)

    _invres(w, sd, 'upsampling_2.inv_res.conv', 'upsampling_2_inv_res',
            expand=True, ds_bn=True)
    _invres(w, sd, 'post_upsampling_2.inv_res.conv',
            'post_upsampling_2_inv_res', expand=True, ds_bn=True)

    for skip in ('skip_2x', 'skip_4x'):
        w.conv(sd, f'{skip}.expansion.0', f'{skip}/expansion/conv')
        w.dsbn(sd, f'{skip}.expansion.1', f'{skip}/expansion/bn')
        w.conv(sd, f'{skip}.reduction.0', f'{skip}/reduction_conv', bias=True)
        w.dsbn(sd, f'{skip}.reduction.1', f'{skip}/reduction_bn')

    if 'rnn.cell_list.0.b_r' in sd:
        cell_t = 'rnn.cell_list.0'
        cell_f = 'rnn/cell'
        for g in ('w_r', 'u_r', 'w_z', 'u_z', 'w', 'u'):
            _mobile_gru_conv(w, sd, f'{cell_t}.{g}', f'{cell_f}/{g}')
        for norm in ('norm_r_x', 'norm_r_h', 'norm_z_x', 'norm_z_h',
                     'norm_out_x', 'norm_out_h'):
            w.dsbn(sd, f'{cell_t}.{norm}', f'{cell_f}/{norm}')
        for p in ('b_r', 'b_z', 'b_h', 'a_r_x', 'a_r_h', 'a_z_x', 'a_z_h',
                  'a_h_x', 'a_h_h'):
            w.params_entry(f'{cell_f}/{p}', sd[f'{cell_t}.{p}'].reshape(-1))
            w.consumed.add(f'{cell_t}.{p}')
        w.consumed.add(f'{cell_t}.drop_mask_1')
        w.conv(sd, 'post_rnn.0', 'post_rnn/conv')
        w.dsbn(sd, 'post_rnn.1', 'post_rnn/bn')

    unconsumed = [k for k in sd
                  if k not in w.consumed and 'num_batches_tracked' not in k]
    return w.params, w.stats, unconsumed


def load_unisal_state_dict(module, state_dict):
    """Fill a port ``UNISAL`` from a reference torch state_dict.

    Every entry is loaded, the ConvGRU's ``rnn``/``post_rnn`` included;
    unconsumed checkpoint keys warn, a missing or misshapen entry raises.
    Returns the module.
    """
    rank = getattr(module, f'smoothing_v_{module.sources[0].lower()}').shape[0]
    params, stats, unconsumed = convert_unisal_state_dict(
        state_dict, smoothing_rank=rank)
    if unconsumed:
        warnings.warn(f'unconsumed checkpoint keys: {unconsumed[:8]}'
                      f'{"..." if len(unconsumed) > 8 else ""}')
    return load_flax_variables(module, {'params': params,
                                        'batch_stats': stats})
