"""The walkthroughs of the port, counterparts of the JAX package's
`examples/*.py`, with the same flags plus `--device` (default: the
card):

    python -m icepy4d_tpu_torch.examples.single_epoch_stereo --assets DIR
    python -m icepy4d_tpu_torch.examples.multitemporal_4d --assets DIR
    python -m icepy4d_tpu_torch.examples.matching_benchmark --assets DIR

`--assets` names a folder in the reference layout: `img/<cam>/` frames
with EXIF timestamps, `calib/<cam>.txt`, and `targets/` with one
`<image stem>.csv` a frame (label,x,y) and `target_world.csv`
(label,X,Y,Z).
"""

from __future__ import annotations

from pathlib import Path


def asset_dir(path) -> Path:
    """`path` as a Path; SystemExit naming it when it is no directory."""
    p = Path(path)
    if not p.is_dir():
        raise SystemExit(f"asset directory {p} does not exist")
    return p
