"""Configuration: an attribute-accessible dict and the YAML parser.

Counterpart of `icepy4d_tpu/utils/config.py`. `yaml` is imported only
when a file is parsed.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


class DotDict(dict):
    """dict with attribute access; `wrap` converts nested dicts."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    __setattr__ = dict.__setitem__
    __delattr__ = dict.__delitem__

    @classmethod
    def wrap(cls, obj):
        if isinstance(obj, dict):
            return cls({k: cls.wrap(v) for k, v in obj.items()})
        if isinstance(obj, list):
            return [cls.wrap(v) for v in obj]
        return obj


def parse_cfg(cfg_file: str | Path,
              root_path: str | Path | None = None) -> DotDict:
    """Read a YAML config: paths resolved against the file's folder (or
    `root_path`), camera names listed from the image folder when absent,
    camera centres as a float32 array, a two-entry epoch_to_process
    expanded to its inclusive range."""
    import yaml

    cfg_file = Path(cfg_file)
    if not cfg_file.exists():
        raise FileNotFoundError(f"Config file {cfg_file} not found")
    with open(cfg_file) as f:
        cfg = DotDict.wrap(yaml.safe_load(f))
    root = Path(root_path) if root_path else cfg_file.parent
    if "paths" in cfg:
        for key in ("image_dir", "calibration_dir", "results_dir"):
            if key in cfg.paths:
                p = Path(cfg.paths[key])
                cfg.paths[key] = p if p.is_absolute() else root / p
        if "camera_names" not in cfg.paths and "image_dir" in cfg.paths:
            cfg.paths["camera_names"] = sorted(
                d.name for d in Path(cfg.paths.image_dir).iterdir()
                if d.is_dir())
    if "georef" in cfg and "camera_centers_world" in cfg.georef:
        cfg.georef.camera_centers_world = np.asarray(
            cfg.georef.camera_centers_world, np.float32)
    if "proc" in cfg and "epoch_to_process" in cfg.proc:
        etp = cfg.proc.epoch_to_process
        if isinstance(etp, list) and len(etp) == 2:
            cfg.proc.epoch_to_process = list(range(int(etp[0]),
                                                   int(etp[1]) + 1))
    return cfg
