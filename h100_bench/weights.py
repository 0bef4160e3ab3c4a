"""The weights a configuration runs with, made or loaded by the benchmark
and handed alike to the program and to the reference.

A configuration's part names its weights as {"npz": path} (a checkpoint
of the repository, flat slash-joined keys, integer segments for lists:
the layout both packages read) or {"random": arch} (drawn on the card
from the run's seed by the architecture's `random_tree`, at the part's
own widths).
"""

from __future__ import annotations

import importlib

import numpy as np
import torch


def load_npz(path) -> dict:
    """Flat-key `.npz` -> nested dict / list tree of numpy arrays (a copy
    of the repository's numpy-only loader)."""
    with np.load(path) as data:
        root: dict = {}
        for key in data.files:
            *parents, leaf = key.split("/")
            node = root
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = data[key]
    return _listify(root)


def _listify(node):
    if isinstance(node, dict):
        if list(node) == ["__empty_dict__"]:
            return {}
        if node and all(k.isdigit() for k in node):
            return [_listify(node[str(i)]) for i in range(len(node))]
        return {k: _listify(v) for k, v in node.items()}
    return node


def tree_map(fn, node):
    if isinstance(node, dict):
        return {k: tree_map(fn, v) for k, v in node.items()}
    if isinstance(node, list):
        return [tree_map(fn, v) for v in node]
    return fn(node)


def to_device(tree, device) -> dict:
    return tree_map(lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                              device=device), tree)


def to_host(tree) -> dict:
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def make(part: dict, seed: int, device):
    """The weights of a configuration's part (its extractor or matcher):
    (tree on `device` for the reference, numpy tree for the program, or
    None where the program reads the checkpoint itself)."""
    spec = part["weights"]
    if "npz" in spec:
        from h100_bench import spec as bench

        return to_device(load_npz(bench.ROOT / spec["npz"]), device), None
    module = importlib.import_module(f"h100_bench.reference.{spec['random']}")
    gen = torch.Generator(device=device).manual_seed(
        int(seed) % (2 ** 63 - 1))
    tree = module.random_tree(gen, device, part)
    return tree, to_host(tree)
