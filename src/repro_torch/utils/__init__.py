from repro_torch.utils.tree import (
    tree_add,
    tree_axpy,
    tree_bytes,
    tree_cast,
    tree_dot,
    tree_norm,
    tree_scale,
    tree_size,
    tree_sub,
    tree_zeros_like,
)

__all__ = [
    "tree_add",
    "tree_axpy",
    "tree_bytes",
    "tree_cast",
    "tree_dot",
    "tree_norm",
    "tree_scale",
    "tree_size",
    "tree_sub",
    "tree_zeros_like",
]
