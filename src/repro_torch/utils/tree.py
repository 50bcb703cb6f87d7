"""Dict-of-tensors tree helpers — the port's stand-in for JAX pytrees.

Parameters, payloads and batches are nested ``dict``s whose leaves are
tensors (or numpy arrays on the host side).  Flattening (``tree_leaves``,
``tree_paths``, ``TreeFlattener``) walks dict keys in SORTED order, the
order ``jax.tree_util`` flattens a dict in, so a flat vector built here
lines up element for element with the JAX package's ``TreeFlattener``
output.  ``tree_map`` keeps key order as it finds it.

``from_numpy_tree`` / ``to_numpy_tree`` carry weights between the two
packages: the JAX package's params (as numpy arrays) map one to one, by
name and layout, onto the port's.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch


def tree_leaves(tree: Any) -> List[Any]:
    """Leaves in sorted-key depth-first order (JAX's dict flatten order)."""
    if isinstance(tree, dict):
        out: List[Any] = []
        for k in sorted(tree):
            out.extend(tree_leaves(tree[k]))
        return out
    return [tree]


def tree_paths(tree: Any, prefix: str = "") -> List[str]:
    """``/``-joined key path of every leaf, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        out: List[str] = []
        for k in sorted(tree):
            out.extend(tree_paths(tree[k], f"{prefix}{k}/"))
        return out
    return [prefix[:-1]]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Leaf-wise ``fn(leaf, *matching leaves of rest)``; the others are
    matched by key.  The result keeps ``tree``'s key order: ``torch.func``
    compares dict structures key order and all, so trees derived from one
    another must not be reordered."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_sub(a, b):
    """Leaf-wise a - b."""
    return tree_map(torch.sub, a, b)


def tree_scale(a, s):
    """Leaf-wise s * a for scalar s."""
    return tree_map(lambda x: x * s, a)


def tree_axpy(alpha, x, y):
    """Leaf-wise alpha * x + y (BLAS axpy)."""
    return tree_map(lambda xi, yi: alpha * xi + yi, x, y)


def tree_stack(trees: List[Any]) -> Any:
    """List of same-structured trees → one tree with a leading axis."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def tree_to(tree: Any, device) -> Any:
    """Host (numpy) or device leaves → tensors on ``device``."""
    return tree_map(lambda x: torch.as_tensor(x, device=device), tree)


def from_numpy_tree(tree: Any, device="cuda") -> Dict[str, Any]:
    """The JAX package's params as numpy arrays (nested dict, or a flat dict
    keyed by ``/``-joined paths as saved in an ``.npz``) → the port's
    params: same names, same layouts, float32 tensors on ``device``."""
    if not isinstance(tree, dict):
        raise TypeError(f"expected a dict of arrays, got {type(tree)}")
    nested: Dict[str, Any] = {}
    for key in tree:
        node, parts = nested, key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        val = tree[key]
        node[parts[-1]] = (from_numpy_tree(val, device)
                           if isinstance(val, dict) else
                           torch.tensor(np.asarray(val), device=device))
    return nested


def to_numpy_tree(params: Any) -> Any:
    """The port's params → nested dict of numpy arrays (host copies)."""
    return tree_map(lambda x: x.detach().cpu().numpy(), params)


class TreeFlattener:
    """Flatten a tree into ONE contiguous f32 vector and back.

    Leaf order is ``tree_leaves`` order (sorted keys, as in JAX), so the
    flat layout matches the JAX package's flattener.  Structure metadata
    is computed once per (paths, shapes, dtypes) and cached.
    """

    _CACHE: Dict[Tuple, "TreeFlattener"] = {}

    def __init__(self, paths, shapes, dtypes):
        self.paths = tuple(paths)
        self.shapes = tuple(shapes)
        self.dtypes = tuple(dtypes)
        self.sizes = tuple(int(np.prod(s)) if s else 1 for s in self.shapes)
        offs = np.cumsum((0,) + self.sizes)
        self.offsets = tuple(int(o) for o in offs[:-1])
        self.size = int(offs[-1])

    @classmethod
    def for_tree(cls, tree) -> "TreeFlattener":
        leaves = tree_leaves(tree)
        key = (tuple(tree_paths(tree)), tuple(tuple(x.shape) for x in leaves),
               tuple(x.dtype for x in leaves))
        hit = cls._CACHE.get(key)
        if hit is None:
            hit = cls._CACHE[key] = cls(*key)
        return hit

    def flatten(self, tree, dtype=torch.float32) -> torch.Tensor:
        """tree → single [size] vector (one concat buffer)."""
        return torch.cat([x.reshape(-1).to(dtype) for x in tree_leaves(tree)])

    def flatten_stacked(self, tree, dtype=torch.float32) -> torch.Tensor:
        """Tree whose leaves carry a leading axis C → [C, size] matrix."""
        leaves = tree_leaves(tree)
        c = leaves[0].shape[0]
        return torch.cat([x.reshape(c, -1).to(dtype) for x in leaves], dim=1)

    def unflatten(self, flat: torch.Tensor, dtype=None) -> Dict[str, Any]:
        """[size] vector → tree; leaves restored to their original dtypes
        (or all cast to ``dtype`` when given)."""
        out: Dict[str, Any] = {}
        for path, o, s, shape, dt in zip(self.paths, self.offsets, self.sizes,
                                         self.shapes, self.dtypes):
            node = out
            parts = path.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = flat[o:o + s].reshape(shape).to(dtype or dt)
        return out
