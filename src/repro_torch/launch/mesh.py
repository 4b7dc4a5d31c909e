"""Production mesh builders: a port of ``repro.launch.mesh``.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with the
reference's axis names, built over the default process group, which must
have exactly the mesh's size: a real group under ``torchrun`` (NCCL, one
card a rank), or the fake group of :func:`fake_process_group` for the
dry-run, which runs every rank's shapes in one CPU process.

  single-pod:  (16, 16)      axes ("data", "model")        = 256 devices
  multi-pod:   (2, 16, 16)   axes ("pod", "data", "model") = 512 devices

The axis helpers (``dp_axes``, ``tp_axis``, ``axis_names``, ``axis_size``)
take a ``DeviceMesh`` or any stand-in with ``axis_names`` and a
``shape`` mapping of axis name to size (the reference tests' ``FakeMesh``).
"""

from __future__ import annotations

import contextlib
import math
import os
import tempfile

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_mesh(shape, axes, device_type: str = "cuda") -> DeviceMesh:
    """A mesh of ``shape`` named ``axes`` over the default process group,
    for tests and elastic re-meshing. Raises unless the group's world size
    is the mesh's size."""
    shape, axes = tuple(int(x) for x in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    size = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError(
            f"make_mesh{shape}: no default process group; open one of {size} ranks "
            "(torchrun, or fake_process_group for a dry-run)"
        )
    world = dist.get_world_size()
    if world != size:
        raise ValueError(f"mesh {shape} needs {size} devices, the process group has {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def axis_names(mesh) -> tuple:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def axis_size(mesh, name: str) -> int:
    """The size of axis ``name``; 0 where the mesh has no such axis."""
    names = axis_names(mesh)
    if name not in names:
        return 0
    if isinstance(mesh, DeviceMesh):
        return mesh.size(names.index(name))
    return int(mesh.shape[name])


def dp_axes(mesh) -> tuple:
    """The data-parallel axes of a mesh (pod folds into DP)."""
    names = axis_names(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def tp_axis(mesh) -> str | None:
    return "model" if "model" in axis_names(mesh) else None


@contextlib.contextmanager
def fake_process_group(world_size: int, rank: int = 0):
    """A default process group of ``world_size`` ranks in this one process,
    on PyTorch's fake backend: collectives return at once without moving
    data, so every rank's shapes (not values) can be traced here. The group
    is destroyed on exit. Refuses to replace a group already open."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_process_group: a default process group is already open")
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def process_group(dev):
    """The default process group for a mesh on ``dev``'s type: the one open
    in this process, else the one ``torchrun`` describes (its environment),
    else a one-rank group in a temporary directory (NCCL on CUDA, gloo on
    the CPU). A group opened here is destroyed on exit."""
    if dist.is_initialized():
        yield
        return
    backend = "nccl" if dev.type == "cuda" else "gloo"
    with tempfile.TemporaryDirectory() as tmp:
        if "WORLD_SIZE" in os.environ:
            if dev.type == "cuda":
                torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
            dist.init_process_group(backend)
        else:
            dist.init_process_group(backend, store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                    rank=0, world_size=1)
        try:
            yield
        finally:
            dist.destroy_process_group()
