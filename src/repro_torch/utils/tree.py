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


def tree_add(a, b):
    """Leaf-wise a + b."""
    return tree_map(torch.add, a, b)


def tree_sub(a, b):
    """Leaf-wise a - b."""
    return tree_map(torch.sub, a, b)


def tree_scale(a, s):
    """Leaf-wise s * a for scalar s."""
    return tree_map(lambda x: x * s, a)


def tree_axpy(alpha, x, y):
    """Leaf-wise alpha * x + y (BLAS axpy)."""
    return tree_map(lambda xi, yi: alpha * xi + yi, x, y)


def tree_dot(a, b) -> torch.Tensor:
    """Sum over all leaves of <a_i, b_i> (flattened inner product), summed
    in leaf order."""
    total = torch.zeros((), dtype=tree_leaves(a)[0].dtype,
                        device=tree_leaves(a)[0].device)
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        total = total + torch.sum(x.reshape(-1) * y.reshape(-1))
    return total


def tree_unflatten(tree: Any, leaves) -> Any:
    """``leaves`` (in ``tree_leaves`` order) put in ``tree``'s structure,
    ``tree``'s own key order kept."""
    it = iter(leaves)

    def go(node):
        if not isinstance(node, dict):
            return next(it)
        vals = {k: go(node[k]) for k in sorted(node)}
        return {k: vals[k] for k in node}

    return go(tree)


def tree_zeros_like(a):
    return tree_map(torch.zeros_like, a)


def tree_size(a) -> int:
    """Total number of scalar parameters in the tree (python int)."""
    return sum(int(x.numel()) for x in tree_leaves(a))


def tree_bytes(a) -> int:
    """Total number of bytes of the tree (python int)."""
    return sum(int(x.numel()) * x.element_size() for x in tree_leaves(a))


def tree_cast(a, dtype):
    """Cast every floating leaf to ``dtype``; leave integer leaves alone."""
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x, a)


def tree_norm(a) -> torch.Tensor:
    """Global L2 norm over the whole tree, in f32 (summed in leaf order)."""
    sq = [torch.sum(torch.square(x.to(torch.float32))) for x in tree_leaves(a)]
    total = torch.zeros((), dtype=torch.float32, device=sq[0].device)
    for s in sq:
        total = total + s
    return torch.sqrt(total)


def tree_stack(trees: List[Any]) -> Any:
    """List of same-structured trees → one tree with a leading axis."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def tree_to(tree: Any, device) -> Any:
    """Host (numpy) or device leaves → tensors on ``device``."""
    return tree_map(lambda x: torch.as_tensor(x, device=device), tree)


def _leaf_from_numpy(arr, device, dtype) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        # JAX's bf16 (ml_dtypes) has no torch counterpart in numpy: carry
        # the bits
        t = torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.tensor(arr)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def from_numpy_tree(tree: Any, device="cuda", dtype=None) -> Dict[str, Any]:
    """The JAX package's params as numpy arrays (nested dict, or a flat dict
    keyed by ``/``-joined paths as saved in an ``.npz``) → the port's
    params: same names, same layouts, tensors on ``device``.  Floating
    leaves keep their dtype (bf16 included) or are cast to ``dtype``."""
    if not isinstance(tree, dict):
        raise TypeError(f"expected a dict of arrays, got {type(tree)}")
    nested: Dict[str, Any] = {}
    for key in tree:
        node, parts = nested, key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        val = tree[key]
        node[parts[-1]] = (from_numpy_tree(val, device, dtype)
                           if isinstance(val, dict) else
                           _leaf_from_numpy(val, device, dtype))
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
        return self._concat([x.reshape(1, -1) for x in tree_leaves(tree)],
                            dtype)[0]

    def flatten_stacked(self, tree, dtype=torch.float32) -> torch.Tensor:
        """Tree whose leaves carry a leading axis C → [C, size] matrix."""
        leaves = tree_leaves(tree)
        c = leaves[0].shape[0]
        return self._concat([x.reshape(c, -1) for x in leaves], dtype)

    def _concat(self, rows, dtype) -> torch.Tensor:
        """[C, n_i] pieces → [C, size] in ``dtype``.  Pieces of another
        dtype are cast as they are copied into the one result, so no cast
        copy of the whole is held beside it (a bf16 bank of C rows of a
        1.75e9-param model would otherwise peak at twice its f32 size);
        ``copy_`` casts as ``to`` does."""
        if all(r.dtype == dtype for r in rows):
            return torch.cat(rows, dim=1)
        out = torch.empty((rows[0].shape[0], self.size), dtype=dtype,
                          device=rows[0].device)
        for r, o, n in zip(rows, self.offsets, self.sizes):
            out[:, o:o + n].copy_(r)
        return out

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

    def unflatten_into(self, tree, flat: torch.Tensor) -> None:
        """[size] vector → ``tree``'s own leaves, written in place, each
        slice cast to its leaf's dtype as ``unflatten`` casts it."""
        leaves = tree_leaves(tree)
        if tuple(tuple(x.shape) for x in leaves) != self.shapes:
            raise ValueError("unflatten_into: the tree is not the one this "
                             "flattener was built for")
        with torch.no_grad():
            for x, o, s in zip(leaves, self.offsets, self.sizes):
                x.copy_(flat[o:o + s].view(x.shape))
