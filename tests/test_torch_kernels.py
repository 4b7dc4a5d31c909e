"""The port's plain kernel versions against the JAX references, on the CPU.

Each ``repro_torch.kernels.<name>`` wrapper takes its plain PyTorch version
for a CPU tensor; it is held against the JAX package's ``ref.py`` on the
shape sweeps of ``tests/test_kernels.py`` and ``tests/test_survival_scan.py``
and their tie-break and tier-precedence regressions, and against the Pallas
kernel under ``interpret=True`` on the sweeps. Tolerances:

  * bitmap_fit, every survival_scan mask and the pressure: exactly equal
    (integer work; the pressure is summed in slot order on both sides);
  * utility_topk: indices exactly, values within rtol 1e-5 (XLA's log2 and
    PyTorch's differ by an ulp or so);
  * zone_aggregate: rtol 1e-5, the JAX package's own bound
    (``tests/test_kernels.py``), since the summation order differs.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import jax_state_to_numpy, port_config

from repro.core import LaminarConfig, MemoryConfig
from repro.core import hotpath as j_hotpath
from repro.core.state import RUNNING, SUSPENDED
from repro.core.state import init_state as j_init_state
from repro.kernels.bitmap_fit import bitmap_fit as j_bitmap_fit
from repro.kernels.bitmap_fit import bitmap_fit_ref
from repro.kernels.survival_scan import survival_scan as j_survival_scan
from repro.kernels.survival_scan import survival_scan_ref
from repro.kernels.utility_topk import utility_topk as j_utility_topk
from repro.kernels.utility_topk import utility_topk_ref
from repro.kernels.zone_aggregate import zone_aggregate as j_zone_aggregate
from repro.kernels.zone_aggregate import zone_aggregate_ref
from repro_torch.core import hotpath
from repro_torch.core.state import state_from_numpy
from repro_torch.kernels.bitmap_fit import bitmap_fit
from repro_torch.kernels.survival_scan import survival_scan
from repro_torch.kernels.utility_topk import utility_topk
from repro_torch.kernels.zone_aggregate import zone_aggregate

T = torch.from_numpy

# the JAX references, jitted: one compile per shape instead of one per op
j_bitmap_fit_ref = jax.jit(bitmap_fit_ref)
j_utility_topk_ref = jax.jit(utility_topk_ref)
j_zone_aggregate_ref = jax.jit(zone_aggregate_ref)
j_survival_scan_ref = jax.jit(
    survival_scan_ref,
    static_argnames=("airlock", "residual", "watermark", "safe", "t_susp", "t_surv"),
)


# ---------------------------------------------------------------------------
# bitmap_fit
# ---------------------------------------------------------------------------


def _bitmap_case(N, W, seed):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2**32, size=(N, W), dtype=np.uint32)
    words[: N // 4] = 0xFFFFFFFF  # long free runs: the contiguous path's edge
    mass = rng.integers(0, 32 * W + 1, size=N).astype(np.int32)
    contig = rng.integers(0, 2, size=N).astype(np.int32)
    return words, mass, contig


@pytest.mark.parametrize("W", [1, 2, 4])
@pytest.mark.parametrize("N", [1, 7, 300, 1024, 1500])
def test_bitmap_fit_sweep(W, N):
    words, mass, contig = _bitmap_case(N, W, 42 + W + N)
    jargs = (jnp.asarray(words), jnp.asarray(mass), jnp.asarray(contig))
    want = np.asarray(j_bitmap_fit_ref(*jargs))
    got = bitmap_fit(T(words.view(np.int32)), T(mass), T(contig.astype(bool)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    pallas = np.asarray(j_bitmap_fit(*jargs, interpret=True))
    np.testing.assert_array_equal(got.numpy(), pallas)


def test_bitmap_fit_edges():
    """Zero demand is always feasible; runs that cross the word boundary."""
    words = np.array(
        [[0, 0], [0x80000000, 0x1], [0xFFFF0000, 0xFFFF], [0xFFFFFFFF, 0xFFFFFFFF],
         [0xFFFFFFFF, 0xFFFFFFFF], [0x0000FFFF, 0xFFFF0000]],
        np.uint32,
    )
    mass = np.array([0, 2, 32, 64, 65, 17], np.int32)
    contig = np.array([1, 1, 1, 1, 1, 1], np.int32)
    want = np.asarray(j_bitmap_fit_ref(jnp.asarray(words), jnp.asarray(mass), jnp.asarray(contig)))
    got = bitmap_fit(T(words.view(np.int32)), T(mass), T(contig.astype(bool)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, [1, 1, 1, 1, 0, 0])


# ---------------------------------------------------------------------------
# utility_topk
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("P,K", [(1, 4), (100, 8), (513, 16), (2048, 8)])
@pytest.mark.parametrize("gamma", [0.5, 1.0, 2.0])
def test_utility_topk_sweep(P, K, gamma):
    rng = np.random.default_rng(P * K)
    s = rng.uniform(0, 64, (P, K)).astype(np.float32)
    h = rng.uniform(0, 32, (P, K)).astype(np.float32)
    eps = rng.normal(0, 0.5, (P, K)).astype(np.float32)
    feas = rng.integers(0, 2, (P, K)).astype(np.int32)
    want = [j_utility_topk_ref(s, h, eps, feas, gamma)]
    if gamma == 1.0:  # the kernel takes gamma as an operand: one gamma suffices
        want.append(j_utility_topk(s, h, eps, feas, gamma, interpret=True))
    gi, gv = utility_topk(T(s), T(h), T(eps), T(feas.astype(bool)), gamma)
    assert gi.dtype == torch.int32 and gv.dtype == torch.float32
    for wi, wv in want:
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=1e-5, atol=1e-5)


def test_utility_topk_ties_take_lowest_index():
    s = np.full((3, 4), 7.0, np.float32)
    h = np.full((3, 4), 1.0, np.float32)
    eps = np.zeros((3, 4), np.float32)
    feas = np.array([[1, 1, 1, 1], [0, 1, 1, 0], [0, 0, 0, 1]], np.int32)
    ri, _ = j_utility_topk_ref(s, h, eps, feas, 1.0)
    gi, _ = utility_topk(T(s), T(h), T(eps), T(feas.astype(bool)), 1.0)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(gi.numpy(), [0, 1, 3])


def test_utility_topk_infeasible_rows():
    z = np.ones((4, 4), np.float32)
    _, gv = utility_topk(T(z), T(z), T(z * 0), torch.zeros((4, 4), dtype=torch.bool), 1.0)
    _, rv = j_utility_topk_ref(z, z, z * 0, np.zeros((4, 4), np.int32), 1.0)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(rv))
    assert (gv.numpy() < -1e37).all()


# ---------------------------------------------------------------------------
# zone_aggregate
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("Z,M", [(1, 8), (10, 300), (20, 301), (33, 257)])
def test_zone_aggregate_sweep(Z, M):
    rng = np.random.default_rng(Z * M)
    sg = rng.uniform(0, 64, (Z, M)).astype(np.float32)
    hg = rng.uniform(0, 8, (Z, M)).astype(np.float32)
    mask = (rng.uniform(size=(Z, M)) < 0.7).astype(np.float32)
    want = [j_zone_aggregate_ref(sg, hg, mask), j_zone_aggregate(sg, hg, mask, interpret=True)]
    gs, gh = zone_aggregate(T(sg), T(hg), T(mask))
    for ws, wh in want:
        np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-5)
        np.testing.assert_allclose(gh.numpy(), np.asarray(wh), rtol=1e-5)


# ---------------------------------------------------------------------------
# survival_scan
# ---------------------------------------------------------------------------

KW = dict(airlock=True, residual=0.3, watermark=0.9, safe=0.8, t_susp=80, t_surv=240)
NAMES = ("pressure", "victim", "resume", "react", "expire")


def _scan_all(st, node, mem, ev, N, *, airlock=True, tier=None, base=None,
              migrating=None, susp_tick=None, surv_deadline=None, t=100,
              pallas=False, **over):
    """Port plain version vs JAX ref (and, with ``pallas``, the Pallas kernel
    in interpret mode): all five outputs exactly equal. Returns the port's
    outputs as numpy."""
    P = len(st)
    kw = {**KW, "airlock": airlock, **over}
    cols = dict(
        st=np.asarray(st, np.int32),
        alloc_node=np.asarray(node, np.int32),
        mem=np.asarray(mem, np.float32),
        ev=np.asarray(ev, np.float32),
        tier=np.zeros(P, np.int32) if tier is None else np.asarray(tier, np.int32),
        migrating=np.zeros(P, bool) if migrating is None else np.asarray(migrating, bool),
        susp_tick=np.zeros(P, np.int32) if susp_tick is None else np.asarray(susp_tick, np.int32),
        surv_deadline=(
            np.full(P, 1 << 24, np.int32) if surv_deadline is None
            else np.asarray(surv_deadline, np.int32)
        ),
        base=np.full(N, 0.95, np.float32) if base is None else np.asarray(base, np.float32),
        t=np.asarray(t, np.int32),
    )
    jargs = {k: jnp.asarray(v) for k, v in cols.items()}
    wants = [j_survival_scan_ref(**jargs, **kw)]
    if pallas:
        wants.append(j_survival_scan(**jargs, **kw, interpret=True))
    got = survival_scan(**{k: T(np.array(v)) for k, v in cols.items()}, **kw)
    got = [g.numpy() for g in got]
    for want in wants:
        for name, g, w in zip(NAMES, got, want):
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)
    assert got[0].dtype == np.float32 and all(g.dtype == bool for g in got[1:])
    return got


@pytest.mark.parametrize("P", [1, 7, 512, 513, 1024, 2500])
@pytest.mark.parametrize("airlock", [False, True])
def test_survival_scan_shape_sweep(P, airlock):
    rng = np.random.default_rng(P + airlock)
    N = 13
    st = rng.choice([0, RUNNING, SUSPENDED], size=P, p=[0.4, 0.45, 0.15])
    node = np.where(rng.uniform(size=P) < 0.85, rng.integers(0, N, P), -1)
    pressure, victim, *_ = _scan_all(
        st, node, rng.uniform(0, 0.3, P), rng.choice([24.0, 48.0, 96.0], P), N,
        airlock=airlock, watermark=0.9 if airlock else 1.0,
        base=rng.uniform(0, 0.7, N), tier=rng.integers(0, 3, P),
        migrating=rng.uniform(size=P) < 0.2, susp_tick=rng.integers(0, 50, P),
        surv_deadline=rng.integers(0, 120, P), pallas=True,
    )
    assert pressure.shape == (N,) and victim.shape == (P,)


@pytest.mark.parametrize("airlock", [False, True])
def test_survival_scan_transitions_fire(airlock):
    """The synthetic mid-run columns of tests/test_hotpath.py: victims (and,
    under Airlock, reactivations) actually happen."""
    rng = np.random.default_rng(3)
    P, N = 777, 33
    st = rng.choice([0, 4, RUNNING, SUSPENDED], size=P, p=[0.3, 0.2, 0.35, 0.15])
    out = _scan_all(
        st, np.where(rng.uniform(size=P) < 0.8, rng.integers(0, N, P), -1),
        rng.uniform(0, 0.4, P), rng.choice([24.0, 48.0, 64.0, 128.0], P), N,
        airlock=airlock, watermark=0.9 if airlock else 1.0,
        tier=rng.integers(0, 3, P), migrating=rng.uniform(size=P) < 0.2,
        susp_tick=rng.integers(0, 50, P), surv_deadline=rng.integers(0, 120, P),
        base=rng.uniform(0, 0.7, N),
    )
    assert out[1].sum() > 0
    if airlock:
        assert out[3].sum() > 0


@pytest.mark.parametrize("airlock", [False, True])
def test_one_victim_per_node(airlock):
    rng = np.random.default_rng(99)
    P, N = 2000, 7
    node = rng.integers(0, N, P)
    _, victim, *_ = _scan_all(
        np.full(P, RUNNING), node, rng.choice([0.01, 0.02], P),
        rng.choice([1024.0, 2048.0], P), N, airlock=airlock,
    )
    assert np.bincount(node[victim], minlength=N).max() == 1
    assert victim.sum() == N


def test_exact_tie_elects_single_highest_slot():
    _, victim, *_ = _scan_all([RUNNING] * 3, [0, 0, 1], [0.1] * 3, [1024.0, 1024.0, 7.0], 2)
    np.testing.assert_array_equal(victim, [False, True, True])


def test_near_equal_scores_pick_true_extreme():
    P = 4096
    st = np.zeros(P, np.int32)
    st[[0, P - 1]] = RUNNING
    mem = np.zeros(P)
    mem[0], mem[P - 1] = 0.1004, 0.1000
    _, victim, *_ = _scan_all(st, np.zeros(P), mem, np.ones(P), 1, airlock=False, watermark=0.9)
    assert victim.sum() == 1 and victim[0]
    ev = np.ones(P)
    ev[0], ev[P - 1] = 0.1000, 0.1004
    _, victim, *_ = _scan_all(st, np.zeros(P), mem, ev, 1)
    assert victim.sum() == 1 and victim[0]


def test_slot_precision_high_slots():
    P = 4099
    _, victim, *_ = _scan_all(np.full(P, RUNNING), np.zeros(P), np.full(P, 0.01), np.full(P, 512.0), 1)
    assert victim.sum() == 1 and victim[P - 1]


def test_tier_precedence():
    # best-effort / batch before prod, whatever the score
    _, victim, *_ = _scan_all(
        [RUNNING] * 4, [0, 0, 1, 1], [0.1] * 4, [1.0, 999.0, 1.0, 999.0], 2, tier=[0, 2, 0, 1]
    )
    np.testing.assert_array_equal(victim, [False, True, False, True])
    # within the worst class: lowest E_v, max slot on exact ties
    _, victim, *_ = _scan_all(
        [RUNNING] * 4, [0] * 4, [0.1] * 4, [5.0, 40.0, 10.0, 10.0], 1, tier=[0, 2, 2, 2]
    )
    np.testing.assert_array_equal(victim, [False, False, False, True])
    # kernel OOM is tier-blind: largest memory dies
    _, victim, *_ = _scan_all(
        [RUNNING] * 2, [0, 0], [0.3, 0.1], [1.0, 1.0], 1, airlock=False, tier=[0, 2]
    )
    np.testing.assert_array_equal(victim, [True, False])


@pytest.mark.parametrize("seed", range(4))
def test_tier_precedence_random_fields(seed):
    rng = np.random.default_rng(1000 + seed)
    P, N = 1200, 11
    _scan_all(
        rng.choice([0, RUNNING, SUSPENDED], size=P, p=[0.3, 0.55, 0.15]),
        np.where(rng.uniform(size=P) < 0.9, rng.integers(0, N, P), -1),
        rng.uniform(0, 0.25, P), rng.uniform(1.0, 256.0, P), N,
        tier=rng.integers(0, 3, P), watermark=0.9, pallas=seed == 0,
    )


@pytest.mark.parametrize("airlock", [False, True])
def test_hotpath_survival_scan_on_bridged_state(airlock):
    """``hotpath.survival_scan`` reads the same columns of a state carried
    over from the JAX package and gives the JAX hotpath's answer."""
    jc = dataclasses.replace(
        LaminarConfig(num_nodes=64, zone_size=32, probe_capacity=1024,
                      max_arrivals_per_tick=64, memory=MemoryConfig(enabled=True)),
        airlock=airlock,
    )
    rng = np.random.default_rng(23)
    s = j_init_state(jc, 0)
    P, N = jc.probe_capacity, jc.num_nodes
    st = rng.choice([0, RUNNING, SUSPENDED], size=P, p=[0.5, 0.4, 0.1])
    occupied = st != 0
    s = s._replace(
        t=jnp.asarray(300, jnp.int32),
        st=jnp.asarray(st.astype(np.int32)),
        alloc_node=jnp.asarray(np.where(occupied, rng.integers(0, N, P), -1).astype(np.int32)),
        mem=jnp.asarray((occupied * rng.uniform(0, 0.2, P)).astype(np.float32)),
        ev=jnp.asarray(rng.choice([24.0, 48.0, 256.0], P).astype(np.float32)),
        tier=jnp.asarray(rng.integers(0, 3, P).astype(np.int32)),
        migrating=jnp.asarray((st == SUSPENDED) & (rng.uniform(size=P) < 0.3)),
        susp_tick=jnp.asarray(rng.integers(0, 300, P).astype(np.int32)),
        surv_deadline=jnp.asarray(rng.integers(100, 500, P).astype(np.int32)),
        amb=jnp.asarray(rng.uniform(0, 0.4, N).astype(np.float32)),
    )
    want = j_hotpath.survival_scan(jc, s)
    got = hotpath.survival_scan(port_config(jc), state_from_numpy(jax_state_to_numpy(s), "cpu"))
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert int(got[1].sum()) > 0
