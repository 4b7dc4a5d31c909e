"""Sharding rules: parameter, batch, cache and optimizer-state specs, a port
of ``repro.parallel.sharding``, rule for rule.

Strategy (the reference's defaults):

  * weights: FSDP-style 2D sharding — last dim over "model" (tensor
    parallel), second-to-last over the DP axes (ZeRO-3 weight sharding,
    training only), each axis degraded to None when the dim is not
    divisible. Norm scales and other 1D leaves stay replicated.
  * activations / batch: batch dim over ("pod", "data").
  * KV caches: batch over the DP axes and sequence over "model".
  * optimizer moments: the spec of their parameter; the Adam step
    replicated.

A spec is a tuple with one entry a tensor dim: ``None`` (not sharded), an
axis name, or a tuple of axis names (sharded over their product, the first
named major), equal to ``tuple(PartitionSpec(...))`` of the reference.
:func:`placements` turns one into DTensor placements on a ``DeviceMesh``,
:func:`distribute` / :func:`shard_like` place tensors by it. The rules are
pure functions of shapes and axis sizes: they take a ``DeviceMesh`` or a
stand-in with ``axis_names`` and a ``shape`` mapping.
"""

from __future__ import annotations

import math
from typing import Any, Callable

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from repro_torch.launch.mesh import axis_names, axis_size, dp_axes

Spec = tuple


def _axis_size(mesh, name) -> int:
    if isinstance(name, tuple):
        return math.prod(_axis_size(mesh, n) for n in name)
    return axis_size(mesh, name)


def _fit(mesh, dim_size: int, axis):
    """Return axis if dim divisible by its mesh size, else None."""
    size = _axis_size(mesh, axis)
    return axis if size and dim_size % size == 0 else None


def _dp(mesh):
    """The DP axes as one spec entry: a name, a tuple of names, or None."""
    dp = dp_axes(mesh)
    return dp if len(dp) > 1 else (dp[0] if dp else None)


# leaves that sit on the ROW-parallel side of a Megatron block: their input
# (contracting) dim carries the model shard; output dim is the residual d.
ROW_PARALLEL_LEAVES = ("w_down", "wo", "out_proj", "w_out")


def param_spec(
    mesh,
    path: str,
    shape,
    train: bool = True,
    row_parallel: bool = False,
    kv_replicated: bool = False,
) -> Spec:
    """Spec for one parameter leaf. ``path`` is the '/'-joined key path.

    ``train=True`` adds ZeRO-3 weight sharding over the DP axes; inference
    steps shard weights over "model" only. ``row_parallel=True`` gives the
    down / out projections row-parallel specs (contracting dim on "model").
    """
    dp = _dp(mesh)
    nd = len(shape)
    if nd == 0:
        return ()
    if nd == 1:  # norm scales, biases, lambdas: replicated
        return (None,)
    # group-stacked leaves have a leading n_groups axis that never shards
    lead = 1 if path.startswith("stack") or path.startswith("enc_stack") else 0
    core = shape[lead:]
    if len(core) == 1:
        return (None,) * nd
    spec = [None] * nd
    leaf_name = path.rsplit("/", 1)[-1]
    if kv_replicated and leaf_name in ("wk", "wv"):
        # Megatron GQA: KV projections replicated over model; ZeRO-3 intact
        if train and dp:
            spec[nd - 2] = _fit(mesh, core[-2], dp)
        return tuple(spec)
    if row_parallel and leaf_name in ROW_PARALLEL_LEAVES:
        # row-parallel: input dim on model; ZeRO-3 over the output dim
        spec[nd - 2] = _fit(mesh, core[-2], "model")
        if train and dp:
            spec[nd - 1] = _fit(mesh, core[-1], dp)
        return tuple(spec)
    # column-parallel default: output dim on model; ZeRO-3 over input dim
    spec[nd - 1] = _fit(mesh, core[-1], "model")
    if train and dp:
        spec[nd - 2] = _fit(mesh, core[-2], dp)
    return tuple(spec)


def map_with_path(fn: Callable[[str, Any], Any], tree: Any, prefix: str = "") -> Any:
    """``fn(path, leaf)`` over the leaves of nested dicts and NamedTuples,
    each path joined as the reference joins a JAX key path (``stack/b0/k``
    for a dict, ``.k`` for a NamedTuple field); ``None`` stays ``None``."""
    if tree is None:
        return None
    join = (lambda k: f"{prefix}/{k}" if prefix else str(k))  # noqa: E731
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, join(k)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_with_path(fn, v, join(f".{f}"))
                            for f, v in zip(tree._fields, tree)))
    return fn(prefix, tree)


def map_specs(fn: Callable[[Any, Spec], Any], tree: Any, specs: Any) -> Any:
    """``fn(leaf, spec)`` over ``tree`` and the spec tree of its shape."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_specs(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_specs(fn, v, s) for v, s in zip(tree, specs)))
    return fn(tree, specs)


def tree_param_specs(
    mesh,
    params_shape: Any,
    train: bool = True,
    row_parallel: bool = False,
    kv_replicated: bool = False,
) -> Any:
    """``param_spec`` over a parameter tree (tensors, ``meta`` or not)."""
    return map_with_path(
        lambda path, leaf: param_spec(mesh, path, tuple(leaf.shape), train=train,
                                      row_parallel=row_parallel,
                                      kv_replicated=kv_replicated),
        params_shape,
    )


def batch_spec(mesh) -> Spec:
    dp = dp_axes(mesh)
    return (dp if len(dp) > 1 else dp[0],)


def tokens_spec(mesh) -> Spec:
    dp = dp_axes(mesh)
    return (dp if len(dp) > 1 else dp[0], None)


def cache_spec(mesh, path: str, shape) -> Spec:
    """KV caches: (G, B, S, Hkv, D) -> (None, DP, 'model', None, None);
    recurrent/SSD states and conv tails: batch over DP, rest replicated."""
    dp = _dp(mesh)
    nd = len(shape)
    spec = [None] * nd
    if path.endswith("pos"):
        return tuple(spec)
    if nd >= 4 and "b" in path:  # stacked KV cache (G, B, S, H, D)
        if dp and shape[1] % _axis_size(mesh, dp) == 0:
            spec[1] = dp
        if nd == 5:
            spec[2] = _fit(mesh, shape[2], "model")
        return tuple(spec)
    if nd >= 2:
        if dp and shape[1] % max(_axis_size(mesh, dp), 1) == 0:
            spec[1] = dp
    return tuple(spec)


def tree_cache_specs(mesh, cache_shape: Any) -> Any:
    return map_with_path(lambda path, leaf: cache_spec(mesh, path, tuple(leaf.shape)),
                         cache_shape)


# ---------------------------------------------------------------------------
# DTensor placements
# ---------------------------------------------------------------------------


def placements(mesh, spec: Spec) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: one a mesh dim, ``Shard(d)``
    where tensor dim ``d`` names that mesh axis, else ``Replicate()``. A
    tuple entry shards its dim over several mesh dims; DTensor splits a dim
    over its mesh dims in mesh order, the first outermost, so the entry's
    names must come in mesh order (the reference's major-to-minor)."""
    names = axis_names(mesh)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        group = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in group]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in mesh order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def named(mesh, spec_tree: Any) -> Any:
    """The placements of every spec of ``spec_tree`` (dicts and NamedTuples
    of specs; a spec is a plain tuple)."""
    if isinstance(spec_tree, dict):
        return {k: named(mesh, v) for k, v in spec_tree.items()}
    if isinstance(spec_tree, tuple) and hasattr(spec_tree, "_fields"):
        return type(spec_tree)(*(named(mesh, v) for v in spec_tree))
    return None if spec_tree is None else placements(mesh, spec_tree)


def distribute(mesh, tree: Any, specs: Any) -> Any:
    """Every tensor of ``tree`` placed on ``mesh`` by its spec (a tree of
    specs shaped as ``tree``, or one spec for every leaf): each rank keeps
    its shard of the full tensor it holds."""
    def one(x, s):
        return distribute_tensor(x, mesh, placements(mesh, s))

    if isinstance(specs, tuple) and not hasattr(specs, "_fields"):
        return map_specs(lambda x, _: one(x, specs), tree, tree)
    return map_specs(one, tree, specs)


def local_shape(mesh, shape, spec: Spec) -> tuple:
    """The shape of one rank's shard (every rule divides evenly)."""
    out = list(shape)
    for d, entry in enumerate(spec):
        if entry is not None:
            n = _axis_size(mesh, entry)
            if out[d] % n:
                raise ValueError(f"dim {d} of {tuple(shape)} does not divide by {entry} ({n})")
            out[d] //= n
    return tuple(out)


def shard_like(mesh, x: torch.Tensor, spec: Spec) -> DTensor:
    """A DTensor of ``x``'s global shape and dtype whose local shard is a new
    uninitialized tensor (``x`` is a ``meta`` stand-in, or a fake tensor of
    the dry-run): no collective runs."""
    local = torch.empty(local_shape(mesh, x.shape, spec), dtype=x.dtype,
                        device=mesh.device_type)
    return DTensor.from_local(local, mesh, placements(mesh, spec), run_check=False,
                              shape=tuple(x.shape), stride=_contiguous_stride(x.shape))


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= max(n, 1)
    return tuple(reversed(stride))

