"""Meshes over `torch.distributed`, port of the reference's
`launch/mesh.py`.

Single pod: (data=16, model=16) = 256 devices. Multi-pod: (pod=2,
data=16, model=16) = 512 devices; the leading "pod" axis carries pure
data parallelism. Each live mesh is a `torch.distributed` DeviceMesh
with ``mesh_dim_names`` ("data", "model") or ("pod", "data", "model"),
wrapped in `sharding.Mesh`: its per-axis process groups are what the
counted collectives of `repro_torch.sharding` run over.

The backend is explicit: NCCL on "cuda" (the default device, one card a
rank, ``LOCAL_RANK`` under torchrun), gloo only when the caller asks for
the CPU. Where no process group exists yet, a mesh of size 1 creates a
world-1 group over a `FileStore` in a fresh temporary directory (no TCP
port); a larger one joins the group torchrun describes in the
environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``)
or raises. A mesh whose size differs from the world size raises, naming
both. `abstract_mesh` names and sizes axes without devices, for spec
resolution at 256 / 512 devices.
"""

from __future__ import annotations

import os
import tempfile

import torch

from repro_torch.device import resolve_device
from repro_torch.sharding import AbstractMesh, Mesh

PRODUCTION = ((16, 16), ("data", "model"))
MULTIPOD = ((2, 16, 16), ("pod", "data", "model"))


def init_process_group(device=None) -> torch.device:
    """Join (or, alone, create) the default process group for ``device``
    ("cuda" -> NCCL, "cpu" -> gloo); returns the rank's device."""
    import torch.distributed as dist

    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        have = dist.get_backend()
        if have != backend:
            raise ValueError(f"the process group runs {have}, the device "
                             f"{dev} needs {backend}")
        return dev
    if "WORLD_SIZE" in os.environ and int(os.environ["WORLD_SIZE"]) > 1:
        dist.init_process_group(backend, device_id=dev
                                if dev.type == "cuda" else None)
        return dev
    path = os.path.join(tempfile.mkdtemp(prefix="repro_mesh_"), "store")
    dist.init_process_group(backend, store=dist.FileStore(path, 1),
                            rank=0, world_size=1)
    return dev


def make_mesh(shape, axis_names, device=None) -> Mesh:
    """A live mesh of ``shape`` over every rank of the process group."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dev = init_process_group(device)
    size = 1
    for s in shape:
        size *= int(s)
    world = dist.get_world_size()
    if size != world:
        raise ValueError(f"mesh {tuple(shape)} over {tuple(axis_names)} "
                         f"has {size} devices, the world size is {world}")
    dm = init_device_mesh(dev.type, tuple(int(s) for s in shape),
                          mesh_dim_names=tuple(axis_names))
    return Mesh(shape, axis_names, device_mesh=dm, device=dev)


def make_local_mesh(device=None) -> Mesh:
    """The 1-device mesh with the production axis names."""
    return make_mesh((1, 1), ("data", "model"), device)


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    shape, names = MULTIPOD if multi_pod else PRODUCTION
    return make_mesh(shape, names, device)


def abstract_mesh(name: str) -> Mesh:
    """The named mesh's axes and sizes without devices."""
    shape, names = _shape_of(name)
    return AbstractMesh(shape, names)


def _shape_of(name: str):
    if name == "local":
        return (1, 1), ("data", "model")
    if name == "production":
        return PRODUCTION
    if name == "multipod":
        return MULTIPOD
    try:
        d, m = (int(p) for p in name.split("x"))
        return (d, m), ("data", "model")
    except ValueError:
        raise ValueError(f"unknown mesh {name!r} (want local | production "
                         f"| multipod | DxM)") from None


def get_mesh(name: str, device=None) -> Mesh:
    """CLI-facing mesh resolver: 'local' | 'production' | 'multipod' |
    an explicit 'DxM' shape (data=D, model=M over D*M ranks)."""
    shape, names = _shape_of(name)
    return make_mesh(shape, names, device)
