"""Parameter loading: the bundled `.npz` checkpoints and the JAX
package's parameter trees, carried into the port's modules.

`load_params` and `bundled_checkpoint` are copies of the numpy-only
loaders in `icepy4d_tpu/models/convert.py`: the `.npz` files hold flat
slash-joined keys (`params/conv1a/kernel`, `layers/0/self_attn/Wqkv/
kernel`), and integer path segments rebuild lists.

`superpoint_state_dict` and `lightglue_params` take such a tree (numpy
arrays in the JAX layout) and return `state_dict`s of the port's
`SuperPointNet` and `LightGlue`: flax HWIO conv kernels become torch
OIHW weights, dense `kernel (in, out)` becomes `weight (out, in)`,
layer-norm `scale` becomes `weight`. LightGlue's `layers` list and the
(H, hd, 3) column order of `Wqkv` are kept as they are.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch


def bundled_checkpoint(name: str):
    """Path of a checkpoint shipped in the repository's `weights/`, or
    None when the file is absent."""
    path = Path(__file__).resolve().parents[2] / "weights" / name
    return path if path.exists() else None


def load_params(path) -> dict:
    """Flat-key `.npz` -> nested dict/list tree of numpy arrays."""
    with np.load(path) as data:
        root: dict = {}
        for key in data.files:
            parts = key.split("/")
            node = root
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[key]

    def listify(node):
        if isinstance(node, dict):
            if list(node.keys()) == ["__empty_dict__"]:
                return {}
            keys = list(node.keys())
            if keys and all(k.isdigit() for k in keys):
                return [listify(node[str(i)]) for i in range(len(keys))]
            return {k: listify(v) for k, v in node.items()}
        return node

    return listify(root)


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _flatten(node, prefix: str, out: dict) -> None:
    """JAX-layout tree -> flat torch state dict (see module docstring)."""
    if isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            _flatten(v, f"{prefix}{i}.", out)
        return
    for key, val in node.items():
        if isinstance(val, (dict, list, tuple)):
            _flatten(val, f"{prefix}{key}.", out)
            continue
        a = np.asarray(val)
        if key == "kernel":
            # conv HWIO -> OIHW, dense (in, out) -> (out, in)
            a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
            key = "weight"
        elif key == "scale":
            key = "weight"
        out[prefix + key] = _tensor(a)


def superpoint_state_dict(params: dict) -> dict:
    """SuperPoint tree ({"params": {"conv1a": {"kernel", "bias"}, ...}})
    -> SuperPointNet state_dict."""
    out: dict = {}
    _flatten(params.get("params", params), "", out)
    return out


def lightglue_params(params: dict) -> dict:
    """LightGlue tree (input_proj, posenc, layers, assign, confidence)
    -> LightGlue state_dict."""
    out: dict = {}
    _flatten(params, "", out)
    return out
