"""Config system: JSON -> attribute dict.

The port's own copy of AttrDict/load_config from nvse_tpu/utils/config.py
(this package imports nothing of nvse_tpu); same keys and defaults.

Accepts the exact key set of the reference configs (reference
`cfgs/*.json`, loaded via ``AttrDict`` at reference utils.py:11-21 and
train_tf_wi_inv.py:447-452) so users can bring their configs unchanged.
Unlike the reference, defaults are applied for keys that some configs
omit, and dataset paths may be relative.
"""
from __future__ import annotations

import json
import os
from typing import Any


class AttrDict(dict):
    """dict with attribute access; same contract as reference utils.py:11-14."""

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        super().__init__(*args, **kwargs)
        self.__dict__ = self

    def get(self, key: str, default: Any = None) -> Any:  # keep dict.get
        return dict.get(self, key, default)


# Defaults for keys that individual reference configs omit but code paths
# read (e.g. gcrn_config.json has no model-specific keys at all).
_DEFAULTS: dict[str, Any] = {
    "batch_size": 16,
    "learning_rate": 2e-4,
    "adam_b1": 0.8,
    "adam_b2": 0.99,
    "lr_decay": 0.999,
    "seed": 1234,
    "training_steps": 1_000_000,
    "training_epochs": 3100,
    "stdout_interval": 500,
    "checkpoint_interval": 5000,
    "summary_interval": 500,
    "validation_interval": 5000,
    "max_to_keep": 5,
    "mrd_weight": 0.1,
    "mpd_reshapes": [2, 3, 5, 7, 11],
    "segment_size": 16384,
    "num_mels": 80,
    "n_fft": 1024,
    "hop_size": 256,
    "win_size": 1024,
    "sampling_rate": 22050,
    "fmin": 0,
    "fmax": 8000,
    "meloss": None,
    "num_workers": 4,
    "test_mel_load": 0,
    "dropout": 0.0,
    "causal": False,
    # nvse_tpu additions (absent from reference):
    "param_dtype": "float32",     # parameter dtype
    "compute_dtype": "float32",   # activation dtype for generator trunks
    "data_axis": "data",          # mesh axis name for data parallelism
    "async_checkpoint": True,     # write checkpoints on a background
                                  # thread from host copies (train/
                                  # checkpoint.py); the final save is
                                  # always synchronous
    "debug_nans": False,          # autograd anomaly mode for the T-F /
                                  # time loop, the reference's
                                  # torch.autograd.set_detect_anomaly
                                  # (reference train_tf_wi_inv.py:4)
}


def load_config(path: str) -> AttrDict:
    """Load a JSON config file into an AttrDict, applying defaults."""
    with open(path) as f:
        data = json.load(f)
    cfg = dict(_DEFAULTS)
    cfg.update(data)
    h = AttrDict(cfg)
    h.config_path = os.path.abspath(path)
    return h
