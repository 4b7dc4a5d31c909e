"""A tick's arbitration rounds in one call (``arbiter.arbitrate_rounds``,
``bitmap_fit_rounds``), on the CPU.

Nets:

  * ``arbitrate_rounds`` on the plain version equals the JAX package's
    ``arb_rounds`` sequential ``repro.core.arbiter.arbitrate`` calls,
    exactly, on the bridged mid-run states of ``test_torch_stages.py``
    (a JAX engine run for 150 ticks, then one tick stage by stage): every
    ``SimState`` field and metric, for ``alloc_policy`` "best" and "first",
    Airlock off and on;
  * at the corner cases of ``repro_torch.kernel_bench.rounds_edge_cases``
    (E_v ties, +-inf and signed-zero E_v, a queued NaN, throttled nodes,
    nodes with fewer queued probes than rounds and one with every probe,
    contiguous and dispersed demands of 0 and past the atoms, 48 atoms a
    node, 3 and 8 words, migrating winners, both policies), each state
    bridged into the JAX package's: ``arbitrate_rounds`` equals
    ``arb_rounds`` calls of JAX's ``arbitrate``, and of the port's one-round
    ``arbitrate``, field for field, and ``bitmap_fit_rounds_ref`` gives each
    round's winners, feasibility and taken words as the port's calls do;
  * the zone-sharded tick's plain version, ``bitmap_fit_rounds_blocked_ref``
    on one rank's zone block, equals the rows of ``bitmap_fit_rounds_ref``
    mapped through the block's ``member`` (padding slots: no winner, no
    words), on one-rank and two-rank splits of jittered zones, on the
    bridged mid-run states, and at every corner above, node 0's probes
    beside padding slots (which point at node 0) included; the ranks'
    blocks together give every node's row once.

The kernels themselves run only on the card (``test_torch_cuda.py``).
"""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import jax_staged_tick, jax_state_to_numpy, port_config

from repro.core import LaminarConfig, LaminarEngine, MemoryConfig
from repro.core import arbiter as jax_arbiter
from repro.core import zhaf as jax_zhaf
from repro_torch.core import arbiter, bitmap
from repro_torch.core import state as tstate
from repro_torch.core.state import state_from_numpy, state_to_numpy
from repro_torch.kernel_bench import (
    blocked_split,
    jittered_counts,
    rounds_blocked_edge_cases,
    rounds_edge_cases,
    rounds_inputs,
    rounds_tensors,
)
from repro_torch.kernels.bitmap_fit import (
    bitmap_fit_rounds,
    bitmap_fit_rounds_blocked,
    bitmap_fit_rounds_blocked_ref,
    bitmap_fit_rounds_ref,
)

ROOT = Path(__file__).resolve().parent.parent
EXP5 = LaminarConfig(
    num_nodes=64, zone_size=32, probe_capacity=1024, max_arrivals_per_tick=64,
    horizon_ms=200.0, rho=0.8, memory=MemoryConfig(enabled=True),
)
MID_RUN_TICKS = 150


def _flat(state) -> dict:
    d = state_to_numpy(state) if isinstance(state.st, torch.Tensor) else jax_state_to_numpy(state)
    out = {k: v for k, v in d.items() if k not in ("metrics", "key", "sched_key")}
    out.update({f"metrics.{k}": v for k, v in d["metrics"].items()})
    return out


def _assert_states_equal(got, want):
    g, w = _flat(got), _flat(want)
    assert set(g) == set(w)
    for k, wv in w.items():
        gv = np.asarray(g[k])
        wv = np.asarray(wv)
        if wv.dtype == np.uint32:  # bitmap words: int32 bit patterns in the port
            gv = gv.view(np.uint32)
        assert gv.dtype == wv.dtype and gv.shape == wv.shape, k
        np.testing.assert_array_equal(gv, wv, err_msg=k)


# ---------------------------------------------------------------------------
# against the JAX package's sequential rounds, on bridged mid-run states
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=[("best", False), ("best", True), ("first", False),
                                        ("first", True)],
                ids=["best-oom", "best-airlock", "first-oom", "first-airlock"])
def staged(request):
    policy, airlock = request.param
    cfg = dataclasses.replace(EXP5, airlock=airlock, alloc_policy=policy)
    eng = LaminarEngine(cfg)
    s0, lam = eng.init(0)
    mid, _ = eng._runner(lam, MID_RUN_TICKS)(s0)
    _, rec = jax_staged_tick(cfg, mid, lam)
    rec = {name: (s, out, extra) for name, s, out, extra in rec}
    return port_config(cfg), rec


def test_rounds_match_jax_sequential_rounds(staged):
    tc, rec = staged
    s_in, _, extra = rec["arbitrate0"]
    want = rec[f"arbitrate{tc.arb_rounds - 1}"][1][0]
    ts = state_from_numpy(jax_state_to_numpy(s_in), "cpu")
    throttled = torch.from_numpy(np.array(extra["throttled"]))
    got = arbiter.arbitrate_rounds(tc, ts, throttled)
    _assert_states_equal(got, want)
    # the mid-run state exercises every round: winners in each
    _, _, _, won, _ = bitmap_fit_rounds_ref(
        ts.st, ts.node, ts.ev, ts.mass, ts.contig, ts.free, throttled,
        rounds=tc.arb_rounds, atoms=tc.atoms_per_node, policy=tc.alloc_policy)
    per_round = [int((won == r).sum()) for r in range(tc.arb_rounds)]
    assert min(per_round) > 0, per_round


# ---------------------------------------------------------------------------
# corner cases: one call against the port's sequential rounds
# ---------------------------------------------------------------------------


def _case_state(args, kw, seed):
    """The case as a port SimState and the same state bridged into the JAX
    package's: its geometry (memory and Airlock on, so a migrating winner
    lands), the case's columns and words, a fifth of the queued probes
    migrating. Returns (JAX config, port config, port state, JAX state)."""
    st, node, ev, mass, contig, words, throttled = args
    P, (N, W) = st.shape[0], words.shape
    jc = LaminarConfig(
        num_nodes=N, zone_size=min(32, N), probe_capacity=P, max_arrivals_per_tick=16,
        horizon_ms=10.0, atoms_per_node=kw["atoms"], arb_rounds=kw["rounds"],
        alloc_policy=kw["policy"], airlock=True, memory=MemoryConfig(enabled=True),
    )
    js, _ = LaminarEngine(jc).init(seed)
    s = state_from_numpy(jax_state_to_numpy(js), "cpu")
    rng = np.random.default_rng(seed)
    mig = torch.from_numpy(rng.uniform(size=P) < 0.2) & (st == tstate.QUEUED)
    s = s._replace(st=st.clone(), node=node.clone(), ev=ev.clone(), mass=mass.clone(),
                   contig=contig.clone(), free=words.clone(), migrating=mig,
                   patience=torch.from_numpy(rng.uniform(-1, 8, P).astype(np.float32)))
    d = state_to_numpy(s)
    js = js._replace(**{f: jnp.asarray(v) for f, v in d.items() if f != "metrics"})
    return jc, port_config(jc), s, js


CORNERS = [name for name in rounds_edge_cases() if not name.startswith("exp7")]


@pytest.fixture(scope="module")
def corners():
    return rounds_edge_cases()


@pytest.mark.parametrize("name", CORNERS)
def test_rounds_equal_sequential_rounds_at_corners(corners, name):
    args, kw = corners[name]
    _, cfg, s, _ = _case_state(args, kw, seed=len(name))
    throttled = args[6]
    seq = s
    bits = bitmap.unpack_bits(s.free, cfg.atoms_per_node)
    for _ in range(cfg.arb_rounds):
        seq, bits = arbiter.arbitrate(cfg, seq, throttled, bits)
    _assert_states_equal(arbiter.arbitrate_rounds(cfg, s, throttled), seq)

    # round by round: the winners, feasibility and words of each call
    winner, feas, alloc, won, admit = bitmap_fit_rounds(*args, **kw)  # the CPU route
    cur = s._replace(migrating=torch.zeros_like(s.migrating))
    bits = bitmap.unpack_bits(cur.free, cfg.atoms_per_node)
    for r in range(cfg.arb_rounds):
        elected, wslot = arbiter.elect(cur.st, cur.node, cur.ev, throttled)
        nxt, bits = arbiter.arbitrate(cfg, cur, throttled, bits)
        torch.testing.assert_close(winner[r], wslot, rtol=0, atol=0)
        assert torch.equal(won == r, elected)
        assert torch.equal(admit[elected], (nxt.st == tstate.RESERVED)[elected])
        assert torch.equal(feas[r], torch.zeros_like(feas[r]).index_fill_(
            0, cur.node[elected & (nxt.st == tstate.RESERVED)].long(), True))
        torch.testing.assert_close(cur.free & ~nxt.free, alloc[r], rtol=0, atol=0)
        cur = nxt
    assert int((won >= 0).sum()) == int((winner >= 0).sum())


@pytest.mark.parametrize("name", CORNERS)
def test_rounds_match_jax_sequential_rounds_at_corners(corners, name):
    """At each corner, one ``arbitrate_rounds`` equals ``arb_rounds`` calls
    of the JAX package's ``arbitrate`` on the bridged state, field for
    field."""
    args, kw = corners[name]
    jc, cfg, s, js = _case_state(args, kw, seed=len(name))
    throttled = args[6]
    jt = jnp.asarray(throttled.numpy())
    bits = jax_zhaf.build_view(jc, js).bits
    for _ in range(jc.arb_rounds):
        js, bits = jax_arbiter.arbitrate(jc, js, jax.random.PRNGKey(0), jt, bits)
    _assert_states_equal(arbiter.arbitrate_rounds(cfg, s, throttled), js)


def test_corner_cases_hit_their_corners(corners):
    """The corner inputs hold what their names say, and the rounds act on
    them as the reference does."""
    def out(name):
        return bitmap_fit_rounds_ref(*corners[name][0], **corners[name][1])

    args, _ = corners["inf_and_signed_zero"]
    st, node, ev = args[:3]
    q = (st == tstate.QUEUED) & ~args[6][node]
    blocked = torch.unique(node[q & (ev == torch.inf)])
    winner = out("inf_and_signed_zero")[0]
    assert len(blocked) and bool((winner[:, blocked] == -1).all())  # +inf blocks its node
    zeros = q & (ev == 0)
    assert bool(torch.signbit(ev[zeros]).any() and (~torch.signbit(ev[zeros])).any())
    args, _ = corners["nan"]
    q = (args[0] == tstate.QUEUED) & ~args[6][args[1]]
    nan_nodes = torch.unique(args[1][q & torch.isnan(args[2])])
    assert len(nan_nodes) and bool((out("nan")[0][:, nan_nodes] == -1).all())
    winner = out("few_queued")[0]
    assert [int((winner[:, n] >= 0).sum()) for n in range(4)] == [1, 2, 3, 3]
    winner, feas, _, won, _ = out("all_on_one")
    assert int((winner >= 0).sum()) == 3 and int((won >= 0).sum()) == 3
    args, kw = corners["mass_0_and_past_atoms"]
    winner, feas = out("mass_0_and_past_atoms")[:2]
    w = winner[winner >= 0].long()
    m, c = args[3][w], args[4][w]
    f = feas[winner >= 0]
    assert bool((~f[c & (m == 0)]).all()) and bool(f[~c & (m == 0)].all())
    assert bool((~f[m > kw["atoms"]]).all())
    assert corners["atoms_48"][1]["atoms"] == 48 and corners["words_8"][0][5].shape[1] == 8


def test_rounds_inputs_pack_the_plane():
    """``rounds_tensors`` packs an (N, A) plane as the port's int32 words."""
    rng = np.random.default_rng(0)
    plane = rng.uniform(size=(9, 48)) < 0.6
    args = rounds_tensors(np.zeros(4), np.zeros(4), np.zeros(4), np.zeros(4),
                          np.zeros(4, bool), plane, np.zeros(9, bool), W=2)
    torch.testing.assert_close(args[5], bitmap.pack_bits(torch.from_numpy(plane)),
                               rtol=0, atol=0)
    args, kw = rounds_inputs(37, 1029, W=3, atoms=80, seed=1)
    assert args[5].shape == (37, 3) and kw == dict(rounds=3, atoms=80, policy="best")
    assert bool((bitmap.unpack_bits(args[5], 96)[:, 80:] == 0).all())


def test_queued_code_agrees_with_state_and_source():
    """The CUDA source holds QUEUED as core.state does."""
    src = (ROOT / "src" / "repro_torch" / "csrc" / "bitmap_fit.cu").read_text()
    (code,) = re.findall(r"constexpr int kQueued = (\d+);", src)
    assert tstate.QUEUED == int(code)


def test_zero_rounds():
    """No round: no winner, every probe's round -1."""
    args, kw = rounds_inputs(37, 1029, seed=2)
    winner, feas, alloc, won, admit = bitmap_fit_rounds_ref(*args, **dict(kw, rounds=0))
    assert winner.shape == (0, 37) and alloc.shape == (0, 37, 2)
    assert bool((won == -1).all()) and not bool(admit.any())


def test_tick_rounds_records_the_flat_tick():
    """``profile_tick`` records what the flat tick gives ``bitmap_fit_rounds``:
    the recorded outputs are the plain version's on the recorded inputs,
    the counts of ``rounds_traffic`` agree with them, and the hot-path
    entry is restored after."""
    from repro_torch import profile_tick
    from repro_torch.core import hotpath

    real = hotpath.bitmap_fit_rounds
    cfg = profile_tick.exp5_config(True, full=False)
    calls = profile_tick.tick_rounds(cfg, 40, 3, device="cpu")
    assert hotpath.bitmap_fit_rounds is real and len(calls) == 3
    wins = 0
    for args, kw, outs in calls:
        want = bitmap_fit_rounds_ref(*args, **kw)
        assert all(torch.equal(o, w) for o, w in zip(outs, want))
        wins += int((outs[0] >= 0).sum())
    tr = profile_tick.rounds_traffic(calls)
    assert wins > 0 and tr["winners"] == pytest.approx(wins / 3)
    nodes = sum(sum(c.values()) for c in tr["free_runs"].values())
    assert nodes == pytest.approx(3 * tr["reach_alloc"]) and 0 < tr["queued_share"] < 1


# ---------------------------------------------------------------------------
# the zone-sharded tick's rounds: one rank's block against the flat rounds
# ---------------------------------------------------------------------------


def _assert_block_is_flat_rows(args, kw, flat=None):
    """The blocked plain version (and the CPU route of its entry) on one
    rank's block equals the flat plain version's rows through ``member``;
    padding slots have no winner and no words. Returns the blocked outputs."""
    member, mask, local = args[7:]
    got = bitmap_fit_rounds_blocked_ref(*args, **kw)
    for g, w in zip(bitmap_fit_rounds_blocked(*args, **kw), got):  # the CPU route
        assert torch.equal(g, w)
    winner, feas, alloc = flat if flat is not None else bitmap_fit_rounds_ref(*args[:7], **kw)[:3]
    R, (Zb, M), W = kw["rounds"], member.shape, args[5].shape[1]
    assert got[0].shape == (R, Zb, M) and got[2].shape == (R, Zb, M, W)
    valid = mask > 0
    m = member.long()
    torch.testing.assert_close(got[0], torch.where(valid, winner[:, m], -1), rtol=0, atol=0)
    assert torch.equal(got[1], feas[:, m] & valid)
    torch.testing.assert_close(got[2], torch.where(valid[..., None], alloc[:, m], 0),
                               rtol=0, atol=0)
    # local is the inverse of member on the valid slots
    slots = torch.arange(Zb * M, dtype=torch.int32).reshape(Zb, M)
    assert torch.equal(local[m][valid], slots[valid])
    return got


def _ranks_cover_every_node(args, kw, counts, ranks):
    """Each rank's block equals the flat rows, and the blocks together give
    every node's row exactly once."""
    flat = bitmap_fit_rounds_ref(*args, **kw)[:3]
    N = args[5].shape[0]
    seen = torch.zeros(N, dtype=torch.int32)
    for rank in range(ranks):
        bargs, _ = blocked_split(args, kw, counts, rank=rank, ranks=ranks)
        _assert_block_is_flat_rows(bargs, kw, flat)
        member, mask = bargs[7], bargs[8]
        seen.index_add_(0, member[mask > 0].long(), torch.ones(int((mask > 0).sum()),
                                                               dtype=torch.int32))
    assert bool((seen == 1).all())
    return flat


@pytest.mark.parametrize("name", CORNERS)
@pytest.mark.parametrize("ranks", [1, 2])
def test_blocked_rounds_are_the_flat_rows_at_corners(corners, name, ranks):
    args, kw = corners[name]
    N = args[5].shape[0]
    counts = jittered_counts(N, min(max(2, N // 5), 307), seed=len(name))
    flat = _ranks_cover_every_node(args, kw, counts, ranks)
    assert int((flat[0] >= 0).sum()) > 0


@pytest.mark.parametrize("seed,N,P,zone,ranks", [(0, 37, 1029, 13, 2), (1, 300, 8192, 61, 3),
                                                 (2, 333, 4096, 40, 2), (3, 64, 2048, 64, 1),
                                                 (4, 100, 4096, 7, 4)])
def test_blocked_rounds_on_jittered_zones(seed, N, P, zone, ranks):
    """Zones of jittered sizes (padding rows, zone rows that do not divide
    by the ranks), both policies."""
    for policy in ("best", "first"):
        args, kw = rounds_inputs(N, P, seed=seed, queued=0.3, policy=policy)
        _ranks_cover_every_node(args, kw, jittered_counts(N, zone, seed=seed), ranks)


def test_blocked_corner_cases_hit_their_corners():
    """``rounds_blocked_edge_cases``: node 0's probes win on node 0's slot,
    never on the padding slots that point at node 0; a queued NaN or +inf
    blocks its node's slot; the blocks equal the flat rows."""
    cases = rounds_blocked_edge_cases()
    assert {n.split("/")[0] for n in cases} == set(rounds_edge_cases()) | {"node0_beside_padding"}
    for name in ("node0_beside_padding/1", "node0_beside_padding/2:0"):
        args, kw = cases[name]
        member, mask = args[7], args[8]
        pads = (mask == 0) & (member == 0)
        assert bool(pads.any())
        winner = _assert_block_is_flat_rows(args, kw)[0]
        slot0 = int(args[9][0])
        assert slot0 >= 0 and int((winner.reshape(winner.shape[0], -1)[:, slot0] >= 0).sum()) > 0
        assert bool((winner[:, pads] == -1).all())
        q = args[0] == tstate.QUEUED
        assert int((q & (args[1] == 0)).sum()) > 100
    for name in ("nan/1", "inf_and_signed_zero/1"):
        args, kw = cases[name]
        st, node, ev = args[:3]
        q = (st == tstate.QUEUED) & ~args[6][node]
        bad = torch.unique(node[q & (torch.isnan(ev) | (ev == torch.inf))])
        winner = _assert_block_is_flat_rows(args, kw)[0].reshape(kw["rounds"], -1)
        assert len(bad) and bool((winner[:, args[9][bad].long()] == -1).all())


@pytest.mark.parametrize("ranks", [1, 2])
def test_blocked_rounds_on_mid_run_states(staged, ranks):
    """On the bridged mid-run state of the JAX engine, with its own zones:
    each rank's block equals the flat rounds' rows."""
    tc, rec = staged
    s_in, _, extra = rec["arbitrate0"]
    ts = state_from_numpy(jax_state_to_numpy(s_in), "cpu")
    throttled = torch.from_numpy(np.array(extra["throttled"]))
    args = (ts.st, ts.node, ts.ev, ts.mass, ts.contig, ts.free, throttled)
    kw = dict(rounds=tc.arb_rounds, atoms=tc.atoms_per_node, policy=tc.alloc_policy)
    flat = _ranks_cover_every_node(args, kw, ts.zcount.numpy(), ranks)
    assert int((flat[0] >= 0).sum()) > 0
