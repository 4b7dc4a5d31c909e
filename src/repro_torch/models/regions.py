"""Local regions of the model under a device mesh.

With plain tensors every model function runs as it is. When the parameters
and the batch are DTensors (``launch.steps`` under a ``DeviceMesh``), most
ops follow DTensor's sharding propagation; the few places where it cannot
(a head split that would cut a head, an ``index_add_`` into a dispatch
buffer, a cache write into a sequence-sharded cache) run as a *local
region*: the inputs are redistributed to stated placements, the region's
plain code runs on each rank's local shard, and its outputs are wrapped
back as DTensors of stated placements. The collectives are the port's own
choice (the redistributions at a region's edges), not XLA's.

Placements here are per mesh dim: batch over the DP axes ("pod", "data")
where the batch divides by their product, heads over "model" where the
head count divides by its size, everything else replicated.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.launch.mesh import dp_axes

def mesh_of(*xs):
    """The device mesh of the first DTensor among ``xs`` (``None``: all plain)."""
    for x in xs:
        if isinstance(x, DTensor):
            return x.device_mesh
    return None


def placements(mesh, batch: Optional[int] = None, batch_dim: int = 0,
               heads: Optional[int] = None, head_dim: Optional[int] = None) -> tuple:
    """Batch dim ``batch_dim`` over the DP axes where ``batch`` divides by
    their product, dim ``head_dim`` over "model" where ``heads`` divides by
    its size; every other mesh dim replicated."""
    names = mesh.mesh_dim_names
    out = [Replicate()] * mesh.ndim
    dp = [names.index(a) for a in dp_axes(mesh)]
    if batch is not None and dp and batch % math.prod(mesh.size(i) for i in dp) == 0:
        for i in dp:
            out[i] = Shard(batch_dim)
    if heads is not None and "model" in names:
        i = names.index("model")
        if heads % mesh.size(i) == 0:
            out[i] = Shard(head_dim)
    return tuple(out)


def replicated(mesh) -> tuple:
    return (Replicate(),) * mesh.ndim


def constrain(x, batch_dim: int = 0, model_dim: Optional[int] = None):
    """Pin a DTensor's layout, as ``with_sharding_constraint`` pins one:
    batch over the DP axes (where it divides), dim ``model_dim`` over
    "model" (where it divides; ``None``: replicated over "model"). A plain
    tensor as it is. The residual stream takes the default; a hidden
    activation between a column- and a row-parallel matmul keeps its
    features over "model". Left to itself DTensor may split a (B, S, d)
    tensor's sequence over "model", which its matmul strategies cannot take
    once the tensor is flattened."""
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    heads = None
    if model_dim is not None:
        model_dim %= x.ndim  # DTensor wants a Shard's dim non-negative
        heads = x.shape[model_dim]
    y = x.redistribute(mesh, placements(mesh, x.shape[batch_dim], batch_dim, heads, model_dim))
    shard = y.to_local()
    if shard.is_contiguous():
        return y
    # a redistribution can leave a strided view, which DTensor's matmul
    # then cannot flatten
    return DTensor.from_local(shard.contiguous(), mesh, y.placements, run_check=False,
                              shape=y.shape, stride=y.stride())


def local(x, mesh, where) -> torch.Tensor:
    """``x`` redistributed to placements ``where``: this rank's shard, as a
    plain tensor. A plain ``x`` counts as replicated."""
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, replicated(mesh), run_check=False)
    return x.redistribute(mesh, where).to_local()


def wrap(x: torch.Tensor, mesh, where) -> DTensor:
    """A rank's local shard ``x`` as the DTensor of placements ``where``."""
    return DTensor.from_local(x, mesh, where, run_check=False)


def param(x, mesh, where):
    """A parameter's whole value for use inside a region of placements
    ``where``. Each rank's gradient then holds only its share of the
    region's work, so it is partial (summed across ranks) over the mesh
    dims the region splits, and replicated over the dims it does not."""
    if not isinstance(x, DTensor):
        return x
    grad = tuple(Partial() if w.is_shard() else Replicate() for w in where)
    return x.redistribute(mesh, replicated(mesh)).to_local(grad_placements=grad)


def _map(fn, tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v) for v in tree))
    return fn(tree)


def batch_local(fn, p, cfg, x, state=None):
    """``fn(p, cfg, x, state) -> (out, new_state)`` (a recurrent or SSD
    mixer) as a local region: ``x``, ``out`` and every state leaf (batch
    first) batch over the DP axes, replicated over "model", the parameters
    whole. Plain tensors call ``fn`` as it is. The mixers' scans, pads and
    depthwise convs then run as on one device, whatever DTensor's own
    strategies for them do."""
    mesh = mesh_of(x)
    if mesh is None:
        return fn(p, cfg, x, state)
    where = placements(mesh, x.shape[0], 0)
    out, new_state = fn(_map(lambda t: param(t, mesh, where), p), cfg, local(x, mesh, where),
                        _map(lambda t: local(t, mesh, where), state))
    return wrap(out, mesh, where), _map(lambda t: wrap(t, mesh, where), new_state)


def full(x):
    """A DTensor's whole value on every rank; a plain tensor as it is."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def shard(x):
    """This rank's shard of a DTensor (no collective); a plain tensor as it is."""
    return x.to_local() if isinstance(x, DTensor) else x
