"""The port's sharding rules (``repro_torch.parallel.sharding``) and mesh
helpers (``repro_torch.launch.mesh``) against the JAX package's, exactly,
on the CPU.

The rules are pure functions of shapes and axis sizes, so both packages
take the reference tests' ``FakeMesh`` stand-in: every parameter leaf of
all 10 archs (walked by key path in both trees, the full configs' shapes),
train and inference, ``row_parallel`` and ``kv_replicated``, on (16, 16),
(2, 16, 16), (1, 1) and (2, 4); every arch's cache tree; the batch and
tokens specs; ``dp_axes`` and ``tp_axis``. A port spec is a tuple equal to
``tuple(PartitionSpec)``. Then ``placements`` on a ``DeviceMesh`` of the
fake process group: a (pod, data) entry splits its dim pod-major, as the
reference's spec does.
"""

from __future__ import annotations

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

from repro.configs import get as jget
from repro.configs import list_archs
from repro.launch import mesh as jmesh
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.parallel import sharding as jsh
from repro_torch.configs import get as tget
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.models import lm as tlm
from repro_torch.parallel import sharding as tsh

ARCHS = list_archs()
MESHES = {
    "16x16": (("data", "model"), (16, 16)),
    "2x16x16": (("pod", "data", "model"), (2, 16, 16)),
    "1x1": (("data", "model"), (1, 1)),
    "2x4": (("data", "model"), (2, 4)),
}
OPTIONS = [dict(train=True), dict(train=False), dict(train=True, row_parallel=True),
           dict(train=True, kv_replicated=True), dict(train=False, row_parallel=True,
                                                      kv_replicated=True)]


class FakeMesh:
    def __init__(self, axes, shape):
        self.axis_names = axes
        self.shape = dict(zip(axes, shape))


def _jax_specs(spec_tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(spec_tree, is_leaf=lambda x: isinstance(x, P))
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): tuple(s)
            for path, s in flat}


def _port_specs(tree, specs) -> dict:
    """The spec of every leaf of ``tree``, keyed by its path."""
    flat = {}

    def walk(t, s, prefix=""):
        join = (lambda k: f"{prefix}/{k}" if prefix else str(k))  # noqa: E731
        if isinstance(t, dict):
            for k in t:
                walk(t[k], s[k], join(k))
        elif isinstance(t, tuple) and hasattr(t, "_fields"):
            for f, v, sv in zip(t._fields, t, s):
                walk(v, sv, join(f".{f}"))
        elif t is not None:
            flat[prefix] = s

    walk(tree, specs)
    return flat


@pytest.fixture(scope="module")
def abstract_params():
    return {a: (jsteps.abstract_params(jget(a)), tsteps.abstract_params(tget(a))) for a in ARCHS}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_reference(abstract_params, arch, mesh):
    m = FakeMesh(*MESHES[mesh])
    jp, tp = abstract_params[arch]
    for kw in OPTIONS:
        want = _jax_specs(jsh.tree_param_specs(m, jp, **kw))
        got = _port_specs(tp, tsh.tree_param_specs(m, tp, **kw))
        assert want == got, (kw, {k: (want[k], got.get(k)) for k in want if want[k] != got.get(k)})


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("batch,seq", [(32, 256), (3, 24), (1, 8)])
def test_cache_specs_equal_the_reference(mesh, batch, seq):
    m = FakeMesh(*MESHES[mesh])
    for arch in ARCHS:
        jc = jax.eval_shape(lambda: jlm.init_cache(jget(arch), batch, seq))  # noqa: B023
        tc = tlm.init_cache(tget(arch), batch, seq, "meta")
        want = _jax_specs(jsh.tree_cache_specs(m, jc))
        got = _port_specs(tc, tsh.tree_cache_specs(m, tc))
        assert want == got, (arch, want, got)
        assert want  # every arch has a cache


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_batch_specs_and_axes_equal_the_reference(mesh):
    m = FakeMesh(*MESHES[mesh])
    assert tsh.batch_spec(m) == tuple(jsh.batch_spec(m))
    assert tsh.tokens_spec(m) == tuple(jsh.tokens_spec(m))
    assert tmesh.dp_axes(m) == jmesh.dp_axes(m)
    assert tmesh.tp_axis(m) == jmesh.tp_axis(m)


def test_pinned_specs():
    """The reference tests' own pins (``tests/test_sharding.py``)."""
    m = FakeMesh(("data", "model"), (16, 16))
    assert tsh.cache_spec(m, "stack/b0/k", (4, 128, 32768, 8, 128)) == (
        None, "data", "model", None, None)
    assert tsh.param_spec(m, "stack/b0/ffn/w_down", (14, 49152, 8192), row_parallel=True) == (
        None, "model", "data")
    assert tsh.param_spec(m, "stack/b0/ffn/w_down", (14, 49152, 8192), train=False,
                          row_parallel=True) == (None, "model", None)
    pod = FakeMesh(("pod", "data", "model"), (2, 16, 16))
    assert tsh.tokens_spec(pod) == (("pod", "data"), None)


def test_placements_on_a_fake_mesh():
    with tmesh.fake_process_group(8):
        m = tmesh.make_mesh((2, 4), ("data", "model"), "cpu")
        assert tmesh.dp_axes(m) == ("data",) and tmesh.tp_axis(m) == "model"
        assert tmesh.axis_size(m, "model") == 4 and tmesh.axis_size(m, "pod") == 0
        assert tsh.placements(m, (None, "data", "model")) == (Shard(1), Shard(2))
        assert tsh.placements(m, ()) == (Replicate(), Replicate())
        assert tsh.placements(m, ("model", None)) == (Replicate(), Shard(0))
        d = tsh.shard_like(m, torch.empty(6, 8, 12, device="meta"), (None, "data", "model"))
        assert tuple(d.shape) == (6, 8, 12) and tuple(d.to_local().shape) == (6, 4, 3)
        tree = {"a": (None, "data", "model"), "b": {"c": ()}}
        assert tsh.named(m, tree) == {"a": (Shard(1), Shard(2)),
                                      "b": {"c": (Replicate(), Replicate())}}
    with tmesh.fake_process_group(8):
        pod = tmesh.make_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
        assert tsh.placements(pod, (("pod", "data"), None)) == (Shard(0), Shard(0), Replicate())
        with pytest.raises(ValueError, match="mesh order"):
            tsh.placements(pod, (("data", "pod"), None))


@pytest.mark.parametrize("rank", range(8))
def test_two_axis_entry_splits_pod_major(rank):
    """Under P(("pod", "data"), None) the reference gives device (p, d, m)
    rows [4 (2p + d), 4 (2p + d) + 4) of 16; the port's placements too."""
    with tmesh.fake_process_group(8, rank=rank):
        pod = tmesh.make_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
        p, d, _ = pod.get_coordinate()
        shape, offset = compute_local_shape_and_global_offset(
            (16, 4), pod, tsh.placements(pod, (("pod", "data"), None)))
        assert tuple(shape) == (4, 4)
        assert tuple(offset) == (4 * (2 * p + d), 0)


def test_make_mesh_needs_a_group_of_its_size():
    with pytest.raises(RuntimeError, match="no default process group"):
        tmesh.make_mesh((2, 4), ("data", "model"), "cpu")
    with tmesh.fake_process_group(4):
        with pytest.raises(ValueError, match="needs 8 devices, the process group has 4"):
            tmesh.make_mesh((2, 4), ("data", "model"), "cpu")
        with pytest.raises(RuntimeError, match="already open"):
            with tmesh.fake_process_group(2):
                pass
