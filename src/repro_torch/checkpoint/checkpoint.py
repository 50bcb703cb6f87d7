"""Dependency-free tree checkpointing (.npz + structure descriptor).

The port of the JAX package's ``checkpoint/checkpoint.py``, in the same
file format, so a file written by either package loads in the other: one
``np.savez_compressed`` archive whose arrays are keyed by the '/'-joined
key path of each leaf (dict keys as they are, list and tuple indices as
``#i``), plus a ``__meta__`` JSON string holding the sorted ``keys``, the
``step``, the caller's ``extra`` and the ``dtypes`` of leaves numpy cannot
hold: bfloat16 is stored as its ``uint16`` bit view with ``"bfloat16"``
recorded.  Tensors are copied to the host to be saved.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Optional

import numpy as np
import torch


def _leaf_paths(tree: Any, prefix=()):
    """(key path, leaf) pairs in the reference's flatten order: dict keys
    sorted, lists and tuples in order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_paths(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaf_paths(v, prefix + (f"#{i}",))
    elif tree is not None:
        yield "/".join(prefix), tree


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view(np.uint16)
        return leaf.numpy()
    return np.asarray(leaf)


def _flatten(tree: Any):
    """{path: numpy array} and {path: "bfloat16"} for the bf16 leaves."""
    out, dtypes = {}, {}
    for key, leaf in _leaf_paths(tree):
        if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
            dtypes[key] = "bfloat16"
        out[key] = _to_numpy(leaf)
    return out, dtypes


def _from_numpy(arr: np.ndarray, dtype_name: Optional[str]) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)
                                .copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def save_checkpoint(path: str, tree: Any, *, step: Optional[int] = None,
                    extra: Optional[Dict[str, Any]] = None) -> str:
    """Save a tree of tensors. ``path`` is a directory; returns the file."""
    os.makedirs(path, exist_ok=True)
    arrays, dtypes = _flatten(tree)
    fname = os.path.join(path, f"ckpt_{step:08d}.npz" if step is not None
                         else "ckpt.npz")
    meta = {"keys": sorted(arrays), "step": step, "extra": extra or {},
            "dtypes": dtypes}
    np.savez_compressed(fname, __meta__=json.dumps(meta), **arrays)
    return fname


def _rebuild(like: Any, leaves: Dict[str, torch.Tensor], prefix=()):
    if isinstance(like, dict):
        return {k: _rebuild(v, leaves, prefix + (str(k),))
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, leaves, prefix + (f"#{i}",))
                          for i, v in enumerate(like))
    if like is None:
        return None
    return leaves["/".join(prefix)]


def load_checkpoint(fname: str, like: Any = None) -> Any:
    """Restore.  With ``like`` given, the arrays are poured into its
    structure (shape-checked), each cast to its leaf's dtype and placed on
    its device; otherwise returns a nested dict of CPU tensors (bfloat16
    leaves as bfloat16)."""
    with np.load(fname, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        dtypes = meta.get("dtypes", {})
        arrays = {k: _from_numpy(z[k], dtypes.get(k)) for k in meta["keys"]}
    if like is None:
        root: Dict[str, Any] = {}
        for key, arr in arrays.items():
            node = root
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = arr
        return root
    paths = dict(_leaf_paths(like))
    missing = set(paths) - set(arrays)
    if missing:
        raise ValueError(f"checkpoint missing keys: {sorted(missing)[:5]} ...")
    leaves = {}
    for key, leaf in paths.items():
        arr = arrays[key]
        shape = tuple(np.shape(leaf))
        if tuple(arr.shape) != shape:
            raise ValueError(f"shape mismatch at {key}: "
                             f"{tuple(arr.shape)} vs {shape}")
        if isinstance(leaf, torch.Tensor):
            arr = arr.to(device=leaf.device, dtype=leaf.dtype)
        leaves[key] = arr
    return _rebuild(like, leaves)


def latest_checkpoint(path: str) -> Optional[str]:
    if not os.path.isdir(path):
        return None
    pat = re.compile(r"ckpt_(\d+)\.npz$")
    best, best_step = None, -1
    for f in os.listdir(path):
        m = pat.match(f)
        if m and int(m.group(1)) > best_step:
            best, best_step = os.path.join(path, f), int(m.group(1))
    if best is None and os.path.exists(os.path.join(path, "ckpt.npz")):
        return os.path.join(path, "ckpt.npz")
    return best
