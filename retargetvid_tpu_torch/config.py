"""Crop parameters and ingest constants.

A copy of the SmartVidCrop parameter dict (reference
``smartVidCrop.py:132-209``) with its two presets, the ICIP-2021 defaults and
the ISM-2021 "best settings", plus the two ingest constants the one-shot
path needs.  Key names, including historical spellings such as
``foces_stab_t``, are kept verbatim.  :class:`KwConfig` is the JSON round
trip of a class's constructor arguments (``<ClassName>.json``), in the
JAX package's format.
"""

from __future__ import annotations

import inspect
import json
from pathlib import Path
from typing import Any

__all__ = ["sc_init_crop_params", "smart_crop_version", "TRANS_THRESHOLD",
           "sal_dims", "KwConfig"]

#: Transition probability threshold (reference ``smartVidCrop.py:64``).
TRANS_THRESHOLD = 0.1


def sal_dims(w: int, h: int, max_input_d: int):
    """Saliency processing dims (reference ``smartVidCrop.py:252-254``)."""
    dsr = float(max(w, h)) / max_input_d
    return int(h / dsr), int(w / dsr)


def smart_crop_version() -> str:
    """Version string (reference ``smartVidCrop.py:2617``)."""
    return '1.4.0-torch'


def sc_init_crop_params(print_dict: bool = False,
                        use_best_settings: bool = False) -> dict:
    """Return the SmartVidCrop parameter dict (ICIP or ISM preset)."""
    crop_params: dict[str, Any] = {}

    crop_params['out_ratio'] = "4:5"
    crop_params['max_input_d'] = 250
    crop_params['skip'] = 6
    crop_params['read_batch'] = 2000

    crop_params['resize_factor'] = 1.0
    crop_params['resize_type'] = 1          # 1: bilinear, 2: cubic, 3: nearest

    crop_params['op_close'] = True
    crop_params['value_bias'] = 1.0         # bias of value -> 3rd clustering dim

    crop_params['exit_on_spread_sal'] = False
    crop_params['exit_on_low_cvrg'] = False

    crop_params['com_km'] = True            # kmeans center-of-mass, else argmax

    crop_params['clust_filt'] = True
    crop_params['select_sum'] = 2           # 1: cluster w/ max sum, else max value
    crop_params['min_d_jump'] = 10          # min pixel distance for a focus jump

    crop_params['focus_stability'] = False
    crop_params['foces_stab_t'] = 60        # (sic) reference spelling preserved
    crop_params['foces_stab_s'] = 1.5

    crop_params['hdbscan_min'] = 26         # min cluster size (density filter)
    crop_params['hdbscan_min_samples'] = None

    crop_params['shift_time'] = 0

    crop_params['loess_filt'] = 1
    crop_params['loess_w_secs'] = 2
    crop_params['loess_degree'] = 2

    crop_params['lp_filt'] = 1
    crop_params['lp_cutoff'] = 2
    crop_params['lp_order'] = 5

    crop_params['t_sal'] = 40               # pad if mean saliency above this
    crop_params['t_cvrg'] = 0.60            # pad if coverage below this
    crop_params['t_threshold'] = 120
    crop_params['t_border'] = -1            # -1 disables border detection

    crop_params['t_cut'] = 120              # low-saliency jump => extra cut

    if use_best_settings:
        # ISM-2021 settings (reference smartVidCrop.py:186-202)
        crop_params['t_threshold'] = 90
        crop_params['hdbscan_min'] = 5
        crop_params['hdbscan_min_samples'] = 3
        crop_params['min_d_jump'] = 1
        crop_params['resize_factor'] = 4
        crop_params['op_close'] = True
        crop_params['value_bias'] = 1.0
        crop_params['select_sum'] = 1
        crop_params['focus_stability'] = True
        crop_params['foces_stab_t'] = 60
        crop_params['foces_stab_s'] = 1.5
        crop_params['t_border'] = -1
        crop_params['lp_filt'] = 1
        crop_params['lp_cutoff'] = 1
        crop_params['lp_order'] = 2
        crop_params['loess_filt'] = 0

    if print_dict:
        for k in crop_params.keys():
            print(k, ':', crop_params[k])

    return crop_params


class KwConfig:
    """Persist constructor kwargs to ``<ClassName>.json`` and reload
    (``retargetvid_tpu/config.py:110-151``, reference
    ``unisal/utils.py:28-44``).

    Every ``__init__`` argument stored as a same-named, JSON-serializable
    attribute is written, except those in ``config_exclude`` (runtime-only
    arguments such as a device).
    """

    config_exclude: tuple = ()

    def asdict(self) -> dict:
        out = {}
        for name in inspect.signature(self.__class__.__init__).parameters:
            if name == 'self' or name in self.config_exclude:
                continue
            if hasattr(self, name):
                val = getattr(self, name)
                try:
                    json.dumps(val)
                except TypeError:
                    continue
                out[name] = val
        return out

    def save_cfg(self, directory) -> None:
        directory = Path(directory)
        directory.mkdir(parents=True, exist_ok=True)
        with open(directory / f"{self.__class__.__name__}.json", 'w') as fp:
            json.dump(self.asdict(), fp, indent=2)

    @classmethod
    def init_from_cfg_dir(cls, directory, **overrides):
        with open(Path(directory) / f"{cls.__name__}.json") as fp:
            cfg = json.load(fp)
        cfg.update(overrides)
        return cls(**cfg)
