"""Parameter loading: the bundled `.npz` checkpoints and the JAX
package's parameter trees, carried into the port's modules.

`load_params`, `save_params` and `bundled_checkpoint` are copies of the
numpy-only loaders and writer in `icepy4d_tpu/models/convert.py`: the `.npz` files hold flat
slash-joined keys (`params/conv1a/kernel`, `layers/0/self_attn/Wqkv/
kernel`), and integer path segments rebuild lists.

`superpoint_state_dict`, `lightglue_params`, `superglue_params`,
`disk_params`, `aliked_params` and `loftr_params` take such a tree
(numpy arrays in the JAX layout) and return `state_dict`s of the port's
modules: flax HWIO conv kernels become torch OIHW weights, dense
`kernel (in, out)` (`w` in the DISK and LoFTR trees) becomes
`weight (out, in)`, `b` becomes `bias`, norm `scale` becomes `weight`.
LightGlue's `layers` list and the (H, hd, 3) column order of `Wqkv` are
kept as they are; SuperGlue's q, k, v and merge channels are permuted
to the head-major order of `models/superglue.py`; LoFTR's layer stacks
are split into one module per layer pair.

The `*_tree_from_state_dict` functions go the other way for SuperPoint,
LightGlue, ALIKED and SuperGlue: a trained module's state dict back to
the JAX layout, exactly inverting the renames, transposes and the
head-major permute, so `save_params` writes a checkpoint both packages
load.

`load_torch_superglue`, `load_torch_disk` and `load_torch_loftr` take
the published checkpoints' state dicts (a path or a dict): numpy-only
copies of the JAX package's key maps (`superglue_params_from_torch`,
`disk_params_from_torch`, `loftr_params_from_torch`) build the JAX
tree, which the functions above then load.
"""

from __future__ import annotations

from pathlib import Path

import re

import numpy as np
import torch

from icepy4d_tpu_torch.models.superglue import head_order


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
    return _listify(root)


def _listify(node):
    """Dicts whose keys are all digits -> lists; `__empty_dict__` -> {}."""
    if isinstance(node, dict):
        if list(node.keys()) == ["__empty_dict__"]:
            return {}
        keys = list(node.keys())
        if keys and all(k.isdigit() for k in keys):
            return [_listify(node[str(i)]) for i in range(len(keys))]
        return {k: _listify(v) for k, v in node.items()}
    return node


def save_params(path, params) -> None:
    """Tree -> one `.npz` of flat slash-joined keys, the layout
    `load_params` reads (and the JAX package's `save_params` writes).
    An empty dict is kept as an `__empty_dict__` entry."""
    flat = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            if not node:
                flat[f"{prefix}/__empty_dict__" if prefix
                     else "__empty_dict__"] = np.zeros(0)
                return
            for k, v in node.items():
                walk(f"{prefix}/{k}" if prefix else str(k), v)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(f"{prefix}/{i}", v)
        else:
            flat[prefix] = np.asarray(node)

    walk("", params)
    np.savez_compressed(path, **flat)


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
        if key in ("kernel", "w"):
            # conv HWIO -> OIHW, dense (in, out) -> (out, in)
            a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
            key = "weight"
        elif key == "scale":
            key = "weight"
        elif key == "b":
            key = "bias"
        out[prefix + key] = _tensor(a)


def _unflatten(state_dict: dict) -> dict:
    """Port state dict -> JAX-layout tree: the inverse of `_flatten` for
    the SuperPoint, LightGlue, ALIKED and SuperGlue trees (OIHW conv
    weights back to HWIO `kernel`, dense `(out, in)` back to `(in, out)`
    `kernel`, 1-D norm `weight` back to `scale`; integer path segments
    back to lists)."""
    root: dict = {}
    for key, t in state_dict.items():
        *path, leaf = key.split(".")
        a = _np(t)
        if leaf == "weight":
            if a.ndim == 4:
                a, leaf = a.transpose(2, 3, 1, 0), "kernel"
            elif a.ndim == 2:
                a, leaf = a.T, "kernel"
            else:
                leaf = "scale"
        node = root
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = a.copy(order="C")
    return _listify(root)


def superpoint_tree_from_state_dict(state_dict: dict) -> dict:
    """SuperPointNet state_dict -> {"params": {"conv1a": {"kernel",
    "bias"}, ...}}, the tree `superpoint_state_dict` takes."""
    return {"params": _unflatten(state_dict)}


def lightglue_tree_from_state_dict(state_dict: dict) -> dict:
    """LightGlue state_dict -> the tree `lightglue_params` takes."""
    return _unflatten(state_dict)


def aliked_tree_from_state_dict(state_dict: dict) -> dict:
    """ALIKEDModel state_dict -> {"params": {"net": ..., "sddh": ...}}."""
    return {"params": _unflatten(state_dict)}


def superglue_tree_from_state_dict(state_dict: dict,
                                   num_heads: int = 4) -> dict:
    """SuperGlue state_dict -> the tree `superglue_params` takes, the
    head-major q / k / v rows and merge columns put back in order."""
    sd = dict(state_dict)
    d = sd["final_proj.weight"].shape[0]
    inv = np.argsort(head_order(d, num_heads))
    n_layers = 1 + max(int(k.split(".")[1]) for k in sd
                       if k.startswith("gnn."))
    for i in range(n_layers):
        g = f"gnn.{i}."
        for n in ("q", "k", "v"):
            sd[g + n + ".weight"] = _np(sd[g + n + ".weight"])[inv]
            sd[g + n + ".bias"] = _np(sd[g + n + ".bias"])[inv]
        sd[g + "merge.weight"] = _np(sd[g + "merge.weight"])[:, inv]
    return _unflatten(sd)


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


def superglue_params(params: dict, num_heads: int = 4) -> dict:
    """SuperGlue tree (kenc, gnn, final_proj, bin_score) -> SuperGlue
    state_dict, q / k / v rows and merge columns in head-major order."""
    out: dict = {}
    _flatten(params, "", out)
    d = out["final_proj.weight"].shape[0]
    perm = torch.from_numpy(head_order(d, num_heads))
    for i in range(len(params["gnn"])):
        g = f"gnn.{i}."
        for n in ("q", "k", "v"):
            out[g + n + ".weight"] = out[g + n + ".weight"][perm]
            out[g + n + ".bias"] = out[g + n + ".bias"][perm]
        out[g + "merge.weight"] = out[g + "merge.weight"][:, perm]
    return out


def _state_dict(path_or_state_dict) -> dict:
    if isinstance(path_or_state_dict, dict):
        return path_or_state_dict
    return torch.load(path_or_state_dict, map_location="cpu",
                      weights_only=True)


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _conv1d_as_dense(sd: dict, name: str) -> dict:
    """Conv1d k=1 (O, I, 1) -> dense {kernel (I, O), bias}."""
    out = {"kernel": _np(sd[f"{name}.weight"])[..., 0].T}
    if f"{name}.bias" in sd:
        out["bias"] = _np(sd[f"{name}.bias"])
    return out


def superglue_tree_from_torch(state_dict: dict, n_layers: int = 18) -> dict:
    """Official SuperGlue state dict (kenc.encoder.*, gnn.layers.{i}.attn.
    proj.{0,1,2} / merge, gnn.layers.{i}.mlp.*, final_proj, bin_score)
    -> JAX-layout tree."""
    sd = state_dict

    def bn(name):
        return {"scale": _np(sd[f"{name}.weight"]),
                "bias": _np(sd[f"{name}.bias"]),
                "mean": _np(sd[f"{name}.running_mean"]),
                "var": _np(sd[f"{name}.running_var"])}

    def mlp(prefix):
        layers, i = [], 0
        while f"{prefix}.{i}.weight" in sd:
            layer = {"dense": _conv1d_as_dense(sd, f"{prefix}.{i}")}
            if f"{prefix}.{i + 1}.running_mean" in sd:
                layer["bn"] = bn(f"{prefix}.{i + 1}")
                i += 3
            else:
                i += 2
            layers.append(layer)
        return layers

    gnn = []
    for li in range(n_layers):
        g = f"gnn.layers.{li}"
        gnn.append({"q": _conv1d_as_dense(sd, f"{g}.attn.proj.0"),
                    "k": _conv1d_as_dense(sd, f"{g}.attn.proj.1"),
                    "v": _conv1d_as_dense(sd, f"{g}.attn.proj.2"),
                    "merge": _conv1d_as_dense(sd, f"{g}.attn.merge"),
                    "mlp": mlp(f"{g}.mlp")})
    return {"kenc": mlp("kenc.encoder"), "gnn": gnn,
            "final_proj": _conv1d_as_dense(sd, "final_proj"),
            "bin_score": np.float32(_np(sd["bin_score"]))}


def load_torch_superglue(path_or_state_dict, n_layers: int = 18,
                         num_heads: int = 4) -> dict:
    """Official SuperGlue checkpoint -> the port's SuperGlue state_dict."""
    return superglue_params(superglue_tree_from_torch(
        _state_dict(path_or_state_dict), n_layers), num_heads)


def disk_params(params: dict) -> dict:
    """DISK tree (down / up lists of {w, b, alpha}) -> DISKNet
    state_dict."""
    out: dict = {}
    _flatten(params, "", out)
    return out


def disk_tree_from_torch(state_dict: dict) -> dict:
    """kornia-layout DISK state dict -> JAX-layout tree. Structural, as
    in the JAX package: entries are grouped by `path_down.{i}` /
    `path_up.{i}` block, and inside a block a 4-D weight is the conv
    kernel, its bias the conv bias, a 1-D weight the PReLU slope."""
    blocks: dict[tuple, dict] = {}
    for key, val in state_dict.items():
        m = re.search(r"path_(down|up)\.(\d+)\.", key)
        if m is None:
            continue
        blk = blocks.setdefault((m.group(1), int(m.group(2))), {})
        arr = _np(val)
        if key.endswith(".weight") and arr.ndim == 4:
            blk["w"] = arr.transpose(2, 3, 1, 0)
            blk["_conv_prefix"] = key[: -len(".weight")]
        elif key.endswith(".weight") and arr.ndim == 1:
            blk["alpha"] = arr
        elif key.endswith(".bias") and arr.ndim == 1:
            blk.setdefault("_biases", {})[key[: -len(".bias")]] = arr

    def finish(blk):
        biases = blk.pop("_biases", {})
        prefix = blk.pop("_conv_prefix", None)
        if prefix is not None and prefix in biases:
            blk["b"] = biases[prefix]
        elif biases:
            blk["b"] = next(iter(biases.values()))
        if "alpha" in blk and blk["alpha"].shape[0] == 1:
            blk["alpha"] = np.broadcast_to(
                blk["alpha"], (blk["w"].shape[2],)).copy()
        return blk

    n_down = 1 + max(i for (d, i) in blocks if d == "down")
    n_up = 1 + max(i for (d, i) in blocks if d == "up")
    return {"down": [finish(blocks[("down", i)]) for i in range(n_down)],
            "up": [finish(blocks[("up", i)]) for i in range(n_up)]}


def load_torch_disk(path_or_state_dict) -> dict:
    """kornia DISK checkpoint (a bare state dict, or one under
    "state_dict" / "extractor") -> the port's DISKNet state_dict."""
    ckpt = _state_dict(path_or_state_dict)
    for key in ("state_dict", "extractor"):
        if isinstance(ckpt, dict) and key in ckpt:
            ckpt = ckpt[key]
    return disk_params(disk_tree_from_torch(ckpt))


def aliked_params(params: dict) -> dict:
    """ALIKED flax tree ({"params": {"net": ..., "sddh": ...}}) ->
    ALIKEDModel state_dict."""
    out: dict = {}
    _flatten(params.get("params", params), "", out)
    return out


def _unstack_pairs(stacked: dict) -> list:
    """{"self": tree, "cross": tree} with a leading layer-pair axis ->
    one {"self", "cross"} tree per pair."""
    def take(node, i):
        if isinstance(node, dict):
            return {k: take(v, i) for k, v in node.items()}
        return np.asarray(node)[i]

    n = len(np.asarray(stacked["self"]["q_proj"]["w"]))
    return [take(stacked, i) for i in range(n)]


def loftr_params(params: dict) -> dict:
    """LoFTR tree (backbone, coarse, fine_preprocess, fine; the
    transformer stacks with a leading pair axis) -> LoFTRNet
    state_dict."""
    out: dict = {}
    _flatten({"backbone": params["backbone"],
              "coarse": _unstack_pairs(params["coarse"]),
              "fine_preprocess": params["fine_preprocess"],
              "fine": _unstack_pairs(params["fine"])}, "", out)
    return out


def loftr_tree_from_torch(state_dict: dict) -> dict:
    """kornia-layout LoFTR state dict (an official checkpoint's
    "matcher." prefixes stripped) -> JAX-layout tree."""
    sd = {(k[len("matcher."):] if k.startswith("matcher.") else k): _np(v)
          for k, v in state_dict.items()}

    def conv(name):
        return {"w": sd[f"{name}.weight"].transpose(2, 3, 1, 0)}

    def bn(name):
        return {"scale": sd[f"{name}.weight"], "bias": sd[f"{name}.bias"],
                "mean": sd[f"{name}.running_mean"],
                "var": sd[f"{name}.running_var"]}

    def block(name, has_down):
        p = {"conv1": conv(f"{name}.conv1"), "bn1": bn(f"{name}.bn1"),
             "conv2": conv(f"{name}.conv2"), "bn2": bn(f"{name}.bn2")}
        if has_down:
            p["down_conv"] = conv(f"{name}.downsample.0")
            p["down_bn"] = bn(f"{name}.downsample.1")
        return p

    def outconv2(name):
        return {"conv1": conv(f"{name}.0"), "bn": bn(f"{name}.1"),
                "conv2": conv(f"{name}.3")}

    backbone = {
        "conv1": conv("backbone.conv1"), "bn1": bn("backbone.bn1"),
        "layer1": [block("backbone.layer1.0", False),
                   block("backbone.layer1.1", False)],
        "layer2": [block("backbone.layer2.0", True),
                   block("backbone.layer2.1", False)],
        "layer3": [block("backbone.layer3.0", True),
                   block("backbone.layer3.1", False)],
        "layer3_outconv": conv("backbone.layer3_outconv"),
        "layer2_outconv": conv("backbone.layer2_outconv"),
        "layer2_outconv2": outconv2("backbone.layer2_outconv2"),
        "layer1_outconv": conv("backbone.layer1_outconv"),
        "layer1_outconv2": outconv2("backbone.layer1_outconv2"),
    }

    def lin(name):
        p = {"w": sd[f"{name}.weight"].T}
        if f"{name}.bias" in sd:
            p["b"] = sd[f"{name}.bias"]
        return p

    def enc_layer(name):
        return {"q_proj": lin(f"{name}.q_proj"),
                "k_proj": lin(f"{name}.k_proj"),
                "v_proj": lin(f"{name}.v_proj"),
                "merge": lin(f"{name}.merge"),
                "mlp0": lin(f"{name}.mlp.0"), "mlp2": lin(f"{name}.mlp.2"),
                "norm1": {"scale": sd[f"{name}.norm1.weight"],
                          "bias": sd[f"{name}.norm1.bias"]},
                "norm2": {"scale": sd[f"{name}.norm2.weight"],
                          "bias": sd[f"{name}.norm2.bias"]}}

    def stack(*nodes):
        if isinstance(nodes[0], dict):
            return {k: stack(*[n[k] for n in nodes]) for k in nodes[0]}
        return np.stack(nodes)

    def stack_pairs(prefix):
        n = len({k.split(".")[2] for k in sd
                 if k.startswith(f"{prefix}.layers.")})
        return stack(*[{"self": enc_layer(f"{prefix}.layers.{2 * i}"),
                        "cross": enc_layer(f"{prefix}.layers.{2 * i + 1}")}
                       for i in range(n // 2)])

    return {"backbone": backbone, "coarse": stack_pairs("loftr_coarse"),
            "fine_preprocess": {
                "down_proj": lin("fine_preprocess.down_proj"),
                "merge_feat": lin("fine_preprocess.merge_feat")},
            "fine": stack_pairs("loftr_fine")}


def load_torch_loftr(path_or_state_dict) -> dict:
    """kornia / official LoFTR checkpoint (a bare state dict or one under
    "state_dict") -> the port's LoFTRNet state_dict."""
    ckpt = _state_dict(path_or_state_dict)
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    return loftr_params(loftr_tree_from_torch(ckpt))
