"""Config loading: defaults tree + strict YAML overlay + CLI overrides (the
port's copy of sparenet_tpu/configs/__init__.py).

Reference parity: configs/base_config.py:115-172 — `merge_into` raises on
unknown keys and type mismatches; `cfg_from_file` overlays a YAML file
(read with PyYAML's ``safe_load``); `cfg_update` applies CLI overrides and
stamps timestamped checkpoint/log directories. ``CONFIG_DIR`` holds the
port's copies of the shipped configs and its evaluation config.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import yaml

from .defaults import AttrDict, default_config
from . import model_names

CONFIG_DIR = os.path.dirname(os.path.abspath(__file__))

__all__ = [
    "CONFIG_DIR",
    "shipped_yaml",
    "AttrDict",
    "default_config",
    "cfg_from_file",
    "cfg_update",
    "merge_into",
    "model_names",
]


def shipped_yaml(model: str, gan: bool = False) -> str:
    """The port's copy of a model's shipped config: ``<model>_gan.yaml``
    with the GAN where there is one, else ``<model>.yaml`` (the root
    scripts' rule)."""
    path = os.path.join(CONFIG_DIR, f"{model}_gan.yaml")
    if gan and os.path.exists(path):
        return path
    return os.path.join(CONFIG_DIR, f"{model}.yaml")


def merge_into(a: dict, b: AttrDict, path: str = "") -> None:
    """Merge dict `a` into config `b`, strict on keys and types.

    Reference: configs/base_config.py:115-145 (`_merge_a_into_b`).
    """
    if not isinstance(a, dict):
        return
    for k, v in a.items():
        if k not in b:
            raise KeyError(f"{path}{k} is not a valid config key")
        old = b[k]
        if isinstance(old, dict):
            if not isinstance(v, dict):
                raise ValueError(
                    f"Type mismatch ({type(old)} vs. {type(v)}) for config key: {path}{k}"
                )
            merge_into(v, old, path=f"{path}{k}.")
            continue
        if old is not None and v is not None and type(old) is not type(v):
            # numeric widening (int -> float) and list/tuple are tolerated,
            # mirroring the reference's np.ndarray escape hatch.
            if isinstance(old, float) and isinstance(v, int):
                v = float(v)
            elif isinstance(old, (list, tuple)) and isinstance(v, (list, tuple)):
                v = type(old)(v)
            elif isinstance(old, np.ndarray):
                v = np.array(v, dtype=old.dtype)
            else:
                raise ValueError(
                    f"Type mismatch ({type(old)} vs. {type(v)}) for config key: {path}{k}"
                )
        b[k] = v


def cfg_from_file(filename: str, cfg: AttrDict | None = None) -> AttrDict:
    """Load a YAML file and merge it over the defaults.

    Reference: configs/base_config.py:149-154.
    """
    if cfg is None:
        cfg = default_config()
    with open(filename, "r", encoding="utf-8") as f:
        overlay = yaml.safe_load(f)
    if overlay:
        merge_into(overlay, cfg)
    return cfg


def cfg_update(cfg: AttrDict, weights=None, device=None, workdir=None,
               timestamp: bool = True) -> str:
    """Apply CLI overrides and create output dir layout.

    Reference: configs/base_config.py:157-172.
    """
    if weights is not None:
        cfg.CONST.weights = weights
    if device is not None:
        cfg.CONST.device = device
    if workdir is not None:
        cfg.DIR.out_path = workdir

    stamp = datetime.datetime.now().isoformat().replace(":", "-") if timestamp else "run"
    output_dir = os.path.join(cfg.DIR.out_path, "%s", stamp)
    cfg.DIR.checkpoints = output_dir % "checkpoints"
    cfg.DIR.logs = output_dir % "logs"
    return output_dir
