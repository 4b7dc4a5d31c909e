"""The DA addressing step and the TEG refresh as one kernel entry each
(``utility_topk_address``, ``zone_aggregate_members``), on the CPU.

Nets:

  * ``utility_topk_address_ref`` (the plain version of the one-launch
    addressing kernel) equals the composition it replaced
    (``_torch_parity.address_composition``: ``zhaf.project``, the tile
    ``utility_topk_ref``, the launchpad score and ``da.address``'s selects)
    on every output, exactly, at the corner cases of
    ``repro_torch.kernel_bench.address_edge_cases`` (no slot addressing,
    every slot addressing, every candidate infeasible, score ties, node -1,
    empty zones, migrating probes that Fast-Fail, bounces into another zone,
    stale reports, no projection, K = 5) and on random tables at Exp5's
    shape; the corners do reach what they name;
  * ``zone_aggregate_members_ref`` equals the JAX package's
    ``zone_aggregate`` (its Pallas kernel in interpret mode, and its
    ``ref``) on the ``rep_S[zmember]`` tiles, within rtol 1e-5 (the JAX
    package's own bound: the summation order differs), at Exp5's 20 x 301
    zones and at ragged shapes; off a refresh tick it keeps the old table;
  * ``profile_tick`` records both entries' calls in the flat engine's tick,
    and the recorded outputs are the plain versions' on the recorded inputs;
  * the launch plans: a thread a slot; a warp a zone row, one CTA at Exp5's
    20 zones, eight at Exp7's 253.

The bridged mid-run states of ``test_torch_stages.py`` hold the two stages
against the JAX engine's; the kernels themselves run only on the card
(``test_torch_cuda.py``).
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch
from _torch_parity import address_composition

from repro.kernels.zone_aggregate import zone_aggregate as j_zone_aggregate
from repro.kernels.zone_aggregate import zone_aggregate_ref as j_zone_aggregate_ref
from repro_torch import profile_tick
from repro_torch.core.state import ADDRESSING, BOUNCING, SUSPENDED, densify_zones
from repro_torch.kernel_bench import address_edge_cases, address_inputs, address_kw
from repro_torch.kernels.utility_topk import plan as topk_plan
from repro_torch.kernels.utility_topk import utility_topk_address, utility_topk_address_ref
from repro_torch.kernels.zone_aggregate import plan as agg_plan
from repro_torch.kernels.zone_aggregate import zone_aggregate_members, zone_aggregate_members_ref

T = torch.from_numpy
CORNERS = address_edge_cases()
OUT = ("st", "node", "zone", "timer", "patience", "counts")


def _assert_equal(got, want):
    assert len(got) == len(want) == len(OUT)
    for name, g, w in zip(OUT, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, w), (name, int((g != w).sum()))


# ---------------------------------------------------------------------------
# utility_topk_address
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(CORNERS))
def test_address_ref_equals_the_composition_at_corners(name):
    args, kw = CORNERS[name]
    _assert_equal(utility_topk_address_ref(*args, **kw), address_composition(*args, **kw))


@pytest.mark.parametrize("seed", [0, 1])
def test_address_ref_equals_the_composition_at_exp5_shape(seed):
    args = address_inputs(5000, 65536, seed=seed)
    kw = address_kw()
    assert args[-1].shape == ()  # the tick, a scalar as the engine's
    got = utility_topk_address_ref(*args, **kw)
    _assert_equal(got, address_composition(*args, **kw))
    assert int(got[-1][0]) == int((args[0] == ADDRESSING).sum()) > 0


def test_address_corners_reach_what_they_name():
    def run(name):
        args, kw = CORNERS[name]
        return args, utility_topk_address_ref(*args, **kw)

    args, (st, *_, counts) = run("none_addressing")
    assert counts.tolist() == [0, 0, 0] and torch.equal(st, args[0])
    args, (*_, counts) = run("all_addressing")
    assert int(counts[0]) == args[0].shape[0]
    args, (st, *_, counts) = run("all_infeasible")
    act = args[0] == ADDRESSING
    assert int(counts[1]) == 0 and bool((st[act] != BOUNCING).all())
    args, (st, node, *_, counts) = run("score_ties")
    act = args[0] == ADDRESSING
    assert int(counts[1]) == 0 and torch.equal(node[act], args[1][act])  # all stay
    args, (st, node, *_) = run("node_minus_1")
    bounced = (args[0] == ADDRESSING) & (st == BOUNCING)
    assert bool(bounced.any()) and bool((node[bounced] >= 0).all())
    args, (st, *_, counts) = run("migrating_fastfail")
    assert int(counts[2]) > 0 and bool((st == SUSPENDED).any())
    args, (st, node, zone, *_) = run("bounce_other_zone")
    moved = (st == BOUNCING) & (zone != args[2])
    assert bool(moved.any()) and torch.equal(zone[moved], args[12][node[moved].long()])
    args, _ = run("empty_zones")
    assert bool(((args[11][args[2].long()] == 0) & (args[0] == ADDRESSING)).any())


def test_address_wrapper_on_cpu_is_the_plain_version_and_writes_no_input():
    args, kw = CORNERS["all_addressing"]
    before = [a.clone() for a in args]
    n0 = utility_topk_address.launches
    _assert_equal(utility_topk_address(*args, **kw), utility_topk_address_ref(*args, **kw))
    assert utility_topk_address.launches == n0  # the CPU launches nothing
    assert all(torch.equal(a, b) for a, b in zip(args, before))


def test_address_plan():
    p = topk_plan.address_plan(65536, 8)
    (L,) = p.launches
    assert (L.kernel, L.grid, L.block) == ("utility_topk_address_kernel", 256, 256)
    assert [(o.name, o.shape) for o in p.outputs] == [
        ("st", (65536,)), ("node", (65536,)), ("zone", (65536,)), ("timer", (65536,)),
        ("patience", (65536,)), ("counts", (3,))]
    assert topk_plan.address_plan(0, 8).launches == ()
    with pytest.raises(ValueError, match="K = 0"):
        topk_plan.address_plan(10, 0)


# ---------------------------------------------------------------------------
# zone_aggregate_members
# ---------------------------------------------------------------------------


def _zones(Z, M, seed):
    """(N, member, mask) of Z zones of 1 to M members, tiling the nodes."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, M + 1, Z).astype(np.int32)
    counts[0] = M
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    member, mask = densify_zones(starts, counts)
    return int(counts.sum()), member, mask


@pytest.mark.parametrize("Z,M", [(20, 301), (1, 8), (3, 13), (7, 33), (33, 257)])
def test_zone_aggregate_members_ref_matches_jax_tiles(Z, M):
    N, member, mask = _zones(Z, M, Z * M)
    rng = np.random.default_rng(N)
    rep_S = rng.integers(0, 65, N).astype(np.float32)
    rep_H = rng.uniform(0, 12, N).astype(np.float32)
    got = zone_aggregate_members_ref(T(rep_S), T(rep_H), T(member), T(mask))
    for want in (j_zone_aggregate(rep_S[member], rep_H[member], mask, interpret=True),
                 jax.jit(j_zone_aggregate_ref)(rep_S[member], rep_H[member], mask)):
        for g, w in zip(got, want):
            assert g.dtype == torch.float32 and g.shape == (Z,)
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=0)


@pytest.mark.parametrize("t,due", [(40, True), (41, False), (0, True), (59, False)])
def test_zone_aggregate_members_keeps_the_table_off_refresh_ticks(t, due):
    N, member, mask = _zones(5, 40, 3)
    rng = np.random.default_rng(t)
    rep_S, rep_H = (T(rng.uniform(0, 64, N).astype(np.float32)) for _ in range(2))
    old = (T(rng.uniform(0, 64, 5).astype(np.float32)), T(rng.uniform(0, 64, 5).astype(np.float32)))
    tick = torch.tensor(t, dtype=torch.int32)
    fresh = zone_aggregate_members_ref(rep_S, rep_H, T(member), T(mask))
    got = zone_aggregate_members(rep_S, rep_H, T(member), T(mask), tick, *old, every=20)
    for g, f, o in zip(got, fresh, old):
        assert torch.equal(g, f if due else o) and g is not o


def test_zone_aggregate_plans():
    for (Z, M), (grid, block) in {(20, 301): (1, 640), (253, 307): (8, 1024),
                                  (33, 257): (2, 1024), (1, 8): (1, 32)}.items():
        for p in (agg_plan.plan("zone_aggregate_members", Z, M),
                  agg_plan.plan("zone_aggregate", Z, M)):
            (L,) = p.launches
            assert (L.kernel, L.grid, L.block) == ("zone_aggregate_kernel", grid, block)
            assert L.grid * L.block // 32 >= Z and L.static_smem == 0
    assert agg_plan.plan("zone_aggregate_members", 0, 8).launches == ()


# ---------------------------------------------------------------------------
# the flat tick's calls, as profile_tick records them
# ---------------------------------------------------------------------------


def test_tick_calls_records_both_entries():
    """Two ticks of the 64-node Exp5 config: one call of each entry a tick,
    whose outputs are the plain versions' on the recorded inputs; the
    wrappers are restored after."""
    from repro_torch.kernels.zone_aggregate import ops as agg_ops

    real = agg_ops.zone_aggregate_members
    cfg = profile_tick.exp5_config(True, full=False)
    entries = ("utility_topk_address", "zone_aggregate_members")
    calls = profile_tick.tick_calls(cfg, 40, 2, entries, device="cpu")
    assert agg_ops.zone_aggregate_members is real
    assert [len(calls[e]) for e in entries] == [2, 2]
    for args, kw, outs in calls["utility_topk_address"]:
        _assert_equal(outs, utility_topk_address_ref(*args, **kw))
    for (args, kw, outs), t in zip(calls["zone_aggregate_members"], (40, 41)):
        assert int(args[4]) == t and kw == {"every": cfg.ticks(cfg.teg_refresh_ms)}
        for g, w in zip(outs, zone_aggregate_members_ref(*args, **kw)):
            assert torch.equal(g, w)
