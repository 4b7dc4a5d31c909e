"""The port's zone-sharded engine against the JAX package, on the CPU.

  1. zone-blocked layout: ``pack_zoned`` / ``unpack_zoned`` equal the JAX
     functions on jittered geometries, device-padding rows and garbage in
     the padding slots included;
  2. ``bitmap_fit_blocked``: the plain version equals the JAX blocked
     reference and the Pallas kernel (interpret mode), and the flat rows;
  3. ``traffic_model`` equals the JAX model on the pinned cases of
     ``tests/test_shard_engine.py`` and more;
  4. ``zone_group`` raises without a process group and on a world-size
     mismatch;
  5. engine parity: on a one-rank gloo group in this process the sharded
     engine equals the flat engine (storm, and a geometry whose zones do not
     divide); on two gloo ranks in two processes (``run_local``) it equals
     the live JAX flat engine on storm and bursty, and on 72 nodes with
     zone size 32; ``run_batch`` equals the flat ``run_batch``;
  6. the sharded tick's rounds: ``MeshPlane.arb_rounds`` equals the flat
     ``arbiter.arbitrate_rounds`` on mid-run states, and the tick calls the
     fused ``bitmap_fit_rounds_blocked`` once (no one-round entry) with five
     ``all_gather``s.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from _torch_parity import (
    assert_outputs_equal,
    first_divergence,
    jax_reference_run,
    jax_tape,
    port_config,
)
from test_shard_engine import _random_partition, _traffic_cases
from test_torch_scenarios import SMALL

from repro.core import LaminarConfig
from repro.core import state as jstate
from repro.kernels.bitmap_fit import ops as jfit
from repro.parallel import engine_mesh as jmesh
from repro.workloads import SCENARIOS as J_SCENARIOS
from repro_torch.core import hotpath
from repro_torch.core import state as tstate
from repro_torch.core.draws import ArrayDraws
from repro_torch.core.engine import LaminarEngine as TorchEngine
from repro_torch.kernels.bitmap_fit import bitmap_fit_blocked_ref, bitmap_fit_ref
from repro_torch.parallel import engine_mesh as tmesh
from repro_torch.parallel.local import run_local


@pytest.fixture
def group1(tmp_path):
    """A one-rank gloo process group in this process (FileStore, no port)."""
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0, world_size=1
    )
    try:
        yield
    finally:
        dist.destroy_process_group()


def _geometry(seed, n):
    starts, counts = _random_partition(np.random.default_rng(seed), n)
    return jstate.densify_zones(starts, counts)


# ---------------------------------------------------------------------------
# 1-2. blocked layout and the blocked feasibility entry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,n", [(0, 100), (5, 17), (9, 1), (3, 50)])
def test_pack_unpack_match_jax(seed, n):
    member, mask = _geometry(seed, n)
    rng = np.random.default_rng(seed + 1)
    tm, tk = torch.from_numpy(member), torch.from_numpy(mask)
    for x in (
        rng.integers(0, 2**32, size=(n, 2), dtype=np.uint32),
        rng.normal(size=(n,)).astype(np.float32),
        rng.integers(-5, 5, size=(n,)).astype(np.int32),
    ):
        want_b = np.asarray(jstate.pack_zoned(jnp.asarray(x), member, mask))
        xt = torch.from_numpy(x.view(np.int32) if x.dtype == np.uint32 else x)
        got_b = tstate.pack_zoned(xt, tm, tk).numpy()
        np.testing.assert_array_equal(got_b.view(want_b.dtype), want_b)
        # device padding rows and garbage in the padding slots never reach
        # the flat layout (padding slots point at node 0)
        pad = np.full((3,) + want_b.shape[1:], 77, want_b.dtype)
        garbage = np.where(
            (mask > 0).reshape(mask.shape + (1,) * (want_b.ndim - 2)), want_b, want_b.dtype.type(123)
        )
        blocked = np.concatenate([garbage, pad])
        want = np.asarray(jstate.unpack_zoned(jnp.asarray(blocked), member, mask, n))
        bt = torch.from_numpy(blocked.view(np.int32) if blocked.dtype == np.uint32 else blocked)
        got = tstate.unpack_zoned(bt, tm, tk, n).numpy()
        np.testing.assert_array_equal(got.view(want.dtype), want)
        np.testing.assert_array_equal(want, x)


@pytest.mark.parametrize("seed,n", [(21, 60), (4, 333)])
def test_bitmap_fit_blocked_matches_jax(seed, n):
    member, mask = _geometry(seed, n)
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2**32, size=(n, 2), dtype=np.uint32)
    words[: n // 3] = 0xFFFFFFFF
    mass = rng.integers(0, 65, size=n).astype(np.int32)
    contig = rng.integers(0, 2, size=n).astype(bool)
    jb = [jstate.pack_zoned(jnp.asarray(a), member, mask) for a in (words, mass, contig)]
    want_ref = np.asarray(jfit.bitmap_fit_blocked_ref(*jb))
    want_pallas = np.asarray(jfit.bitmap_fit_blocked(*jb, interpret=True))
    tm, tk = torch.from_numpy(member), torch.from_numpy(mask)
    tb = [
        tstate.pack_zoned(torch.from_numpy(a), tm, tk)
        for a in (words.view(np.int32), mass, contig)
    ]
    got = bitmap_fit_blocked_ref(*tb)
    assert got.dtype == torch.int32 and got.shape == member.shape
    np.testing.assert_array_equal(got.numpy(), want_ref)
    np.testing.assert_array_equal(got.numpy(), want_pallas)
    # the hot-path entry takes the plain version on CPU tensors, and a row's
    # result does not depend on the blocking
    np.testing.assert_array_equal(hotpath.bitmap_fit_blocked(*tb).numpy(), want_ref)
    flat = bitmap_fit_ref(*(torch.from_numpy(a) for a in (words.view(np.int32), mass, contig)))
    np.testing.assert_array_equal(tstate.unpack_zoned(got, tm, tk, n).numpy(), flat.numpy())


# ---------------------------------------------------------------------------
# 3-4. traffic model and the process group
# ---------------------------------------------------------------------------


def test_traffic_model_matches_jax():
    cases = [
        (LaminarConfig(num_nodes=64, zone_size=32), 2, 2, 32),
        (LaminarConfig(num_nodes=16384, zone_size=256), 64, 4, 256),
        (LaminarConfig(num_nodes=65536, zone_size=256), 256, 4, 310),
        (LaminarConfig(num_nodes=100, zone_size=32, teg_refresh_ms=3.0), 4, 3, None),
        (LaminarConfig(num_nodes=72, zone_size=32), 3, 1, 38),
    ]
    for cfg, z, d, m in cases:
        assert tmesh.traffic_model(port_config(cfg), z, d, max_zone=m) == jmesh.traffic_model(
            cfg, z, d, max_zone=m
        )
    pinned = {
        "64_zones2_dev2": tmesh.traffic_model(
            port_config(LaminarConfig(num_nodes=64, zone_size=32)), 2, 2, max_zone=32
        ),
        "16k_zones64_dev4": tmesh.traffic_model(
            port_config(LaminarConfig(num_nodes=16384, zone_size=256)), 64, 4, max_zone=256
        ),
    }
    assert pinned == _traffic_cases()


def test_zone_group_validates_world_size(tmp_path):
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="process group"):
        tmesh.zone_group(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0, world_size=1
    )
    try:
        assert tmesh.zone_group() == tmesh.zone_group(1) == 1
        with pytest.raises(ValueError):
            tmesh.zone_group(2)
        with pytest.raises(ValueError):
            tmesh.ZoneShardedEngine(port_config(SMALL), num_devices=2, device="cpu")
        eng = tmesh.ZoneShardedEngine(port_config(SMALL), device="cpu")
        assert eng.traffic() == jmesh.ZoneShardedEngine(SMALL, num_devices=1).traffic()
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# 5. engine parity
# ---------------------------------------------------------------------------


def test_mesh_plane_gather_is_unpack(group1):
    cfg = port_config(dataclasses.replace(SMALL, num_nodes=72))
    s = tstate.init_state(cfg, 0, "cpu")
    plane = tmesh.MeshPlane(cfg, s.zmember, s.zmask)
    x = torch.arange(72, dtype=torch.float32) * 3 + 1
    xb = tstate.pack_zoned(x, s.zmember, s.zmask)
    torch.testing.assert_close(plane._to_flat(xb), x, rtol=0, atol=0)
    assert (plane.msk_l > 0).sum() == 72
    # one rank's block holds every node: local is the inverse of the slots
    slots = torch.arange(plane.Zb * plane.M, dtype=torch.int32).reshape(plane.Zb, plane.M)
    torch.testing.assert_close(plane.local, tstate.unpack_zoned(slots, s.zmember, s.zmask, 72),
                               rtol=0, atol=0)


@pytest.mark.parametrize("num_nodes", [64, 72])
def test_mesh1_matches_flat(group1, num_nodes):
    """One rank: the sharded engine (blocked node plane, gathers of one
    block) equals the flat engine, storm preset, Airlock on."""
    cfg = port_config(
        dataclasses.replace(SMALL, num_nodes=num_nodes, scenario=J_SCENARIOS["storm"])
    )
    flat = TorchEngine(cfg, device="cpu").run(seed=0)
    mesh = tmesh.ZoneShardedEngine(cfg, num_devices=1, device="cpu").run(seed=0)
    assert flat["arrived"] > 0 and flat["node_failures"] > 0
    assert_outputs_equal(flat, mesh)


CASES = {
    "storm": dataclasses.replace(SMALL, scenario=J_SCENARIOS["storm"]),
    "bursty": dataclasses.replace(SMALL, scenario=J_SCENARIOS["bursty"]),
    # zones of ~32 nodes over 72: zone rows that do not divide by the ranks
    "storm-72": dataclasses.replace(
        SMALL, num_nodes=72, horizon_ms=50.0, scenario=J_SCENARIOS["storm"]
    ),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_two_ranks_match_jax_flat(case):
    cfg = CASES[case]
    want, _, zones = jax_reference_run(cfg)
    draws = ArrayDraws(jax_tape(cfg).arrays)
    outs = run_local(port_config(cfg), 2, seed=0, draws=draws, device="cpu")
    assert len(outs) == 2
    for got in outs:  # both ranks hold the same replicated result
        assert first_divergence(want, got) is None, first_divergence(want, got)
        assert_outputs_equal(want, got)
    assert want["arrived"] > 0
    if case == "storm-72":
        assert zones % 2 == 1  # a padding zone row on the second rank
    if case.startswith("storm"):
        assert want["node_failures"] > 0


def test_run_local_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_local(port_config(SMALL), 2)
    with pytest.raises(ValueError):
        run_local(port_config(SMALL), 2, device="tpu")


def test_run_batch_matches_flat_run_batch(group1):
    cfg = port_config(dataclasses.replace(SMALL, horizon_ms=50.0))
    seeds = [0, 3]
    flat = TorchEngine(cfg, device="cpu").run_batch(seeds)
    mesh = tmesh.ZoneShardedEngine(cfg, num_devices=1, device="cpu").run_batch(seeds)
    assert [o["seed"] for o in mesh] == seeds
    for a, b in zip(flat, mesh):
        assert_outputs_equal(a, b)
    assert flat[0]["arrived"] != flat[1]["arrived"]
    with pytest.raises(ValueError):
        tmesh.ZoneShardedEngine(cfg, device="cpu").run_batch([])


# ---------------------------------------------------------------------------
# 6. the sharded tick's rounds
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("airlock", [False, True])
def test_arb_rounds_equal_the_flat_rounds(group1, monkeypatch, airlock):
    """On the states the flat storm tick (memory on, node failures) hands
    its rounds, ticks 0 to 59 on 72 nodes, one ``MeshPlane.arb_rounds``
    gives the state ``arbiter.arbitrate_rounds`` gives, field for field;
    again with a fifth of the nodes throttled."""
    from repro_torch.core import arbiter
    from test_torch_arbitration import _assert_states_equal

    cfg = port_config(dataclasses.replace(SMALL, num_nodes=72, airlock=airlock,
                                          scenario=J_SCENARIOS["storm"]))
    eng = TorchEngine(cfg, device="cpu")
    s, _ = eng.init(0)
    plane = tmesh.MeshPlane(cfg, s.zmember, s.zmask)
    real = arbiter.arbitrate_rounds
    seen = {"won": 0, "throttled": 0}

    def both(cfg_, s_, throttled):
        want = real(cfg_, s_, throttled)
        _assert_states_equal(plane.arb_rounds(cfg_, s_, throttled), want)
        thr = torch.arange(cfg.num_nodes) % 5 == 0
        _assert_states_equal(plane.arb_rounds(cfg_, s_, thr), real(cfg_, s_, thr))
        seen["won"] += int(want.metrics.op_arb - s_.metrics.op_arb)
        seen["throttled"] += int(throttled.sum())
        return want

    monkeypatch.setattr(arbiter, "arbitrate_rounds", both)
    out = eng.run(seed=0, num_ticks=60)
    assert seen["won"] > 0 and out["node_failures"] > 0
    assert seen["throttled"] > 0 or not airlock


def test_sharded_tick_calls_the_fused_rounds_once(group1):
    """The sharded tick runs its rounds through one bitmap_fit_rounds_blocked
    call, never a one-round entry nor the flat rounds, and makes five
    all_gathers a tick (s_true, run_true, the rounds, zS, zH)."""
    from repro_torch.profile_tick import counting_gathers, recording

    cfg = port_config(dataclasses.replace(SMALL, horizon_ms=20.0))
    entries = ("bitmap_fit_rounds_blocked", "bitmap_fit_rounds", "bitmap_fit_blocked",
               "bitmap_fit")
    eng = tmesh.ZoneShardedEngine(cfg, num_devices=1, device="cpu")
    with recording(*entries) as calls, counting_gathers() as gathers:
        out = eng.run(seed=0)
    assert [len(calls[e]) for e in entries] == [cfg.num_ticks, 0, 0, 0]
    assert len(gathers) == 5 * cfg.num_ticks
    assert out["started"] > 0


def test_tick_calls_records_the_sharded_tick(group1):
    """``profile_tick.tick_calls(..., sharded=True)`` records what the sharded
    tick gives ``bitmap_fit_rounds_blocked``: the recorded outputs are the
    plain version's on the recorded inputs, and on one rank the traffic of
    the block is the flat tick's traffic of the same ticks."""
    from repro_torch import profile_tick
    from repro_torch.kernels.bitmap_fit import bitmap_fit_rounds_blocked_ref

    cfg = profile_tick.exp5_config(True, full=False)
    entry = "bitmap_fit_rounds_blocked"
    calls = profile_tick.tick_calls(cfg, 40, 3, (entry,), device="cpu", sharded=True)[entry]
    assert len(calls) == 3
    for args, kw, outs in calls:
        assert len(args) == 10
        want = bitmap_fit_rounds_blocked_ref(*args, **kw)
        assert all(torch.equal(o, w) for o, w in zip(outs, want))
    flat = profile_tick.tick_rounds(cfg, 40, 3, device="cpu")
    tr = profile_tick.rounds_traffic(calls)
    assert tr == profile_tick.rounds_traffic(flat) and tr["winners"] > 0
