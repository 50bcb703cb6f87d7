"""Per-rank op analysis of one eager step on DTensors.

The counterpart of the JAX package's ``launch/hlo_analysis.py``, which
parses XLA's compiled per-device HLO.  Torch runs eagerly, so there is no
module to parse and no while-loop trip count to correct: ``OpCounter`` is a
``TorchDispatchMode`` that sees every op a rank runs on its local tensors
(DTensor ops desugar into local ops and c10d functional collectives before
it counts them) and records:

  * ``flops``            — ``torch.utils.flop_counter``'s formulas (its
                           ``flop_registry``: matmuls, convolutions,
                           attention) on the local shapes, as
                           ``FlopCounterMode`` applies them;
  * ``bytes_accessed``   — Σ input + output bytes of every local op but
                           views and bare allocations: eager mode fuses
                           nothing, so each op reads its inputs from and
                           writes its outputs to device memory;
  * ``collectives``      — per kind (the reference's names), the result
                           bytes and the count of each c10d functional
                           collective, and the bytes by mesh axis (from the
                           op's process group);
  * ``peak_bytes``       — the most bytes live at once: the arguments'
                           local storages, plus every storage an op's
                           output brings into being, from its creation
                           until Python frees it (a ``weakref.finalize``
                           on the storage; views and in-place results
                           share a storage and add nothing).  Memory an op
                           uses inside and frees before it returns is not
                           seen.

All numbers are one rank's.
"""
from __future__ import annotations

import weakref
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "broadcast",
}
_FUNCOL_NS = ("_c10d_functional", "c10d_functional",
              "_c10d_functional_autograd")


def _bytes(x) -> int:
    """Bytes of the tensors in an op's arguments or results (tensors,
    lists and tuples of them, dicts of kwargs)."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_bytes(y) for y in x)
    if isinstance(x, dict):
        return sum(_bytes(y) for y in x.values())
    return 0


def _moves_nothing(func) -> bool:
    """Views (a result that aliases an input without writing it) and bare
    allocations move no bytes."""
    name = packet_name(func)
    if name.startswith("empty") or name == "_unsafe_view":
        return True
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def packet_name(func) -> str:
    return func._overloadpacket.__name__


class OpCounter(TorchDispatchMode):
    """Count one rank's FLOPs, bytes and collectives (module docstring).
    ``mesh`` names the axes of the collectives' process groups."""

    def __init__(self, mesh=None, live=()):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flop_registry = flop_registry
        self.flops = 0
        self.bytes_accessed = 0
        self.coll_bytes: Dict[str, int] = {}
        self.coll_count: Dict[str, int] = {}
        self.axis_bytes: Dict[str, int] = {}
        self._axis_of: Dict[str, str] = {}
        if mesh is not None:
            for i, name in enumerate(mesh.mesh_dim_names):
                self._axis_of[mesh.get_group(i).group_name] = name
        # storage id -> bytes of every storage live now (``live``: tensors
        # that exist before the step, its arguments)
        self._storages: Dict[int, int] = {}
        self.live_bytes = 0
        for t in tree_flatten(live)[0]:
            self._track(t)
        self.peak_bytes = self.live_bytes

    def _track(self, t) -> None:
        """Count ``t``'s storage from now until it is freed, once."""
        from torch.distributed.tensor import DTensor
        if isinstance(t, DTensor):
            t = t.to_local()
        if not isinstance(t, torch.Tensor):
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return
        self._storages[key] = st.nbytes()
        self.live_bytes += st.nbytes()
        weakref.finalize(st, self._free, key).atexit = False

    def _free(self, key) -> None:
        self.live_bytes -= self._storages.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        """Count one local op.  An op on fake tensors is not one: DTensor's
        sharding propagation runs ops on them at an op's first call to
        learn its output shapes (and its cache keeps them alive), so
        counting them would raise a process's first case above the same
        case run again, in FLOPs, bytes and peak."""
        from torch._subclasses.fake_tensor import is_fake
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented       # let DTensor desugar to local ops
        out = func(*args, **kwargs)
        if any(is_fake(t) for t in tree_flatten((args, kwargs, out))[0]):
            return out
        for t in tree_flatten(out)[0]:
            self._track(t)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        packet = func._overloadpacket
        if func.namespace in _FUNCOL_NS:
            kind = KINDS.get(packet.__name__)
            if kind is not None:
                b = _bytes(out)
                self.coll_bytes[kind] = self.coll_bytes.get(kind, 0) + b
                self.coll_count[kind] = self.coll_count.get(kind, 0) + 1
                names = [a for a in args if isinstance(a, str)]
                group = kwargs.get("group_name",
                                   names[-1] if names else None)
                axis = self._axis_of.get(group, "other")
                self.axis_bytes[axis] = self.axis_bytes.get(axis, 0) + b
            return out
        if packet in self._flop_registry:
            self.flops += int(self._flop_registry[packet](
                *args, **kwargs, out_val=out))
        if func.namespace == "aten" and not _moves_nothing(func):
            self.bytes_accessed += _bytes((args, kwargs)) + _bytes(out)
        return out

    def record(self) -> Dict[str, object]:
        return {
            "flops": float(self.flops),
            "bytes_accessed": float(self.bytes_accessed),
            "collectives": {
                "bytes_by_kind": {k: float(v)
                                  for k, v in self.coll_bytes.items()},
                "count_by_kind": dict(self.coll_count),
                "bytes_by_axis": {k: float(v)
                                  for k, v in self.axis_bytes.items()},
                "total_bytes": float(sum(self.coll_bytes.values())),
            },
            "peak_bytes": self.peak_bytes,
        }


def _local_tensors(tree):
    """The tensors of a tree, each DTensor as this rank's local shard."""
    from torch.distributed.tensor import DTensor
    for t in tree_flatten(tree)[0]:
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            yield t


def local_bytes(tree) -> int:
    """Bytes this rank holds of a tree of DTensors and tensors (its local
    shards)."""
    return sum(t.numel() * t.element_size() for t in _local_tensors(tree))


def aliased_bytes(out, args) -> int:
    """Bytes of this rank's local output tensors that lie in an argument's
    storage: outputs written in place into their arguments, as XLA's
    ``alias_size_in_bytes`` counts the donated buffers its outputs reuse.
    Each output counts once, by its own bytes (as ``local_bytes``)."""
    arg_st = {t.untyped_storage()._cdata for t in _local_tensors(args)}
    seen, total = set(), 0
    for t in _local_tensors(out):
        key = (t.untyped_storage()._cdata, t.storage_offset(), t.numel())
        if key[0] in arg_st and key not in seen:
            seen.add(key)
            total += t.numel() * t.element_size()
    return total


def analyze(fn, args, mesh, kwargs: Optional[dict] = None):
    """Run ``fn(*args)`` once under ``OpCounter`` (``args`` live
    throughout); returns (its outputs, the counter's record)."""
    counter = OpCounter(mesh, live=(args, kwargs))
    with counter:
        out = fn(*args, **(kwargs or {}))
    return out, counter.record()
