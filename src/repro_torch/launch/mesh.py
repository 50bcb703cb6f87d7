"""Production mesh builders on ``torch.distributed``.

The port of the JAX package's ``launch/mesh.py``.  Functions, never module
constants: a mesh needs a process group, which the caller initialises
(``nccl`` on cards, ``gloo`` on CPUs, or the ``"fake"`` backend for the dry
run, ``fake_world``).  The mesh's device type follows that backend.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch.distributed as dist


def _device_type() -> str:
    return "cuda" if "nccl" in str(dist.get_backend()) else "cpu"


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]):
    """Arbitrary mesh over the initialised process group (tests use small
    meshes like (2, 4))."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(_device_type(), tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    """Single pod: (data=16, model=16) = 256 ranks.
    Multi-pod:  (pod=2, data=16, model=16) = 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_host_mesh(data: int = 1, model: int = 1, pods: Optional[int] = None):
    """Mesh over the process group's ranks with the production axis names
    (a world of 1 on one card gives ``(pod 1, data 1, model 1)``)."""
    if pods:
        return make_mesh((pods, data, model), ("pod", "data", "model"))
    return make_mesh((data, model), ("data", "model"))


@contextlib.contextmanager
def fake_world(world_size: int, rank: int = 0):
    """A ``"fake"`` process group of ``world_size`` ranks in this process
    (collectives move no data): what the dry run resolves and runs its
    meshes on.  Destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()
