"""The PyTorch port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU (and ``nvcc`` to build the kernels) and
skips without one. Run them on a machine with a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Each kernel gets the same inputs on the card and, as CPU copies, in its plain
version; integer and mask outputs must be equal, float outputs equal where
the operation order is the same and within the stated tolerance where it is
not. No JAX here: the machine with the card need not have it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import LaminarConfig, LaminarEngine, MemoryConfig
from repro_torch.core.draws import TorchDraws
from repro_torch.kernel_bench import address_edge_cases, address_inputs, address_kw
from repro_torch.kernels import bitmap_fit, survival_scan, utility_topk, zone_aggregate

pytestmark = pytest.mark.cuda

RUNNING, SUSPENDED = 6, 7


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA (an NVIDIA GPU)")
    return torch.device("cuda")


def _both(fn, args, kw, dev):
    """Run ``fn`` on CPU tensors (plain version) and CUDA copies (kernel)."""
    cpu = fn(*args, **kw)
    gpu = fn(*[a.to(dev) if isinstance(a, torch.Tensor) else a for a in args], **kw)
    torch.cuda.synchronize()
    cpu = cpu if isinstance(cpu, tuple) else (cpu,)
    gpu = gpu if isinstance(gpu, tuple) else (gpu,)
    return cpu, tuple(g.cpu() for g in gpu)


@pytest.mark.parametrize("W", [1, 2, 4])
@pytest.mark.parametrize("N", [1, 7, 300, 5000])
def test_bitmap_fit_matches_plain(dev, W, N):
    rng = np.random.default_rng(42 + W + N)
    words = torch.from_numpy(rng.integers(0, 2**32, size=(N, W), dtype=np.uint32).view(np.int32))
    # include long free runs so the contiguous path is exercised
    words[: N // 3] = -1
    mass = torch.from_numpy(rng.integers(0, 32 * W + 1, size=N).astype(np.int32))
    contig = torch.from_numpy(rng.integers(0, 2, size=N).astype(bool))
    n0 = bitmap_fit.bitmap_fit.launches
    (want,), (got,) = _both(bitmap_fit.bitmap_fit, (words, mass, contig), {}, dev)
    assert bitmap_fit.bitmap_fit.launches == n0 + 1
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("Z,M,W", [(1, 1, 1), (3, 13, 2), (257, 310, 2), (9, 40, 4)])
def test_bitmap_fit_blocked_matches_plain(dev, Z, M, W):
    """The zone-blocked entry launches the same kernel over the (Z * M, W)
    rows of a padded block (padding slots zeroed), and counts on its own."""
    from repro_torch.core.state import densify_zones

    rng = np.random.default_rng(Z * M * W)
    counts = np.maximum(1, rng.integers(M // 2, M + 1, Z)).astype(np.int32)
    counts[0] = M
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    member, mask = densify_zones(starts, counts)
    N = int(counts.sum())
    words = rng.integers(0, 2**32, size=(N, W), dtype=np.uint32)
    words[: N // 3] = 0xFFFFFFFF
    valid = mask > 0
    wb = torch.from_numpy(np.where(valid[..., None], words[member], 0).astype(np.uint32).view(np.int32))
    mass = torch.from_numpy(np.where(valid, rng.integers(0, 32 * W + 1, N)[member], 0).astype(np.int32))
    contig = torch.from_numpy(valid & (rng.integers(0, 2, N)[member] == 1))
    n0, f0 = bitmap_fit.bitmap_fit_blocked.launches, bitmap_fit.bitmap_fit.launches
    (want,), (got,) = _both(bitmap_fit.bitmap_fit_blocked, (wb, mass, contig), {}, dev)
    assert bitmap_fit.bitmap_fit_blocked.launches == n0 + 1
    assert bitmap_fit.bitmap_fit.launches == f0
    assert got.shape == (Z, M)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _rounds_cases():
    from repro_torch.kernel_bench import rounds_edge_cases, rounds_inputs

    cases = dict(rounds_edge_cases())
    for label, (N, P) in {"ragged": (37, 1029), "exp5": (5000, 65536),
                          "exp7": (65536, 131072)}.items():
        for policy in ("best", "first"):
            cases[f"{label}-{policy}"] = rounds_inputs(N, P, seed=N, policy=policy)
    return cases


ROUNDS_CASES = ("ev_ties", "inf_and_signed_zero", "nan", "half_throttled", "few_queued",
                "all_on_one", "mass_0_and_past_atoms", "atoms_48", "words_3", "words_8",
                "first_fit", "first_fit_words_8", "exp7_all_queued", "ragged-best",
                "ragged-first", "exp5-best", "exp5-first", "exp7-best", "exp7-first")


@pytest.mark.parametrize("case", ROUNDS_CASES)
def test_bitmap_fit_rounds_matches_plain(dev, case):
    """One launch a call, bit-equal to R rounds of the plain version (on CPU
    copies, and for the NaN case also on the card, whose scatter-max must
    agree), at the corner cases of ``kernel_bench.rounds_edge_cases`` and at
    ragged, Exp5 and Exp7 shapes under both policies."""
    args, kw = _rounds_cases()[case]
    n0, f0 = bitmap_fit.bitmap_fit_rounds.launches, bitmap_fit.bitmap_fit.launches
    want, got = _both(bitmap_fit.bitmap_fit_rounds, args, kw, dev)
    assert bitmap_fit.bitmap_fit_rounds.launches == n0 + 1
    assert bitmap_fit.bitmap_fit.launches == f0
    names = ("winner", "feas", "alloc", "round", "admit")
    for name, w, g in zip(names, want, got):
        torch.testing.assert_close(g, w, rtol=0, atol=0, msg=name)
    if case == "nan":
        plain_cuda = bitmap_fit.bitmap_fit_rounds_ref(*[a.to(dev) for a in args], **kw)
        for name, w, g in zip(names, plain_cuda, got):
            torch.testing.assert_close(g, w.cpu(), rtol=0, atol=0, msg=name)
    assert int((want[0] >= 0).sum()) > 0


def test_bitmap_fit_rounds_is_one_device_kernel(dev):
    """A call captured in a CUDA graph is one kernel node and nothing else."""
    from repro_torch.kernel_bench import graph_nodes, rounds_inputs

    args, kw = rounds_inputs(5000, 65536, seed=3)
    args = [a.to(dev) for a in args]
    nodes = graph_nodes(lambda: bitmap_fit.bitmap_fit_rounds(*args, **kw))
    assert nodes == {"kernel": 1, "memcpy": 0, "memset": 0, "other": 0}, nodes


def test_bitmap_fit_rounds_cluster_fits_the_card(dev):
    """At every shape of kernel_contract.GEOMETRIES, and for 1 to 8 words a
    node, the one cluster can be resident with the non-portable attribute;
    registers fit 512 threads a block."""
    from repro_torch.analysis.kernel_contract import GEOMETRIES
    from repro_torch.kernels import _build
    from repro_torch.kernels.bitmap_fit import ops as bops
    from repro_torch.kernels.bitmap_fit import plan as bp

    for k in range(1, len(bp.KERNELS)):
        regs = _build.attrs("bitmap_fit", k)["registers"]
        assert regs * bp.ROUND_THREADS <= 65536, (bp.KERNELS[k], regs)
    for W in (1, 2, 3, 8):
        for g in GEOMETRIES.values():
            occ = bops.rounds_cluster_occupancy(bp.rounds_plan(g["P"], g["N"], W, 3, 32 * W))
            assert occ["clusters"] >= 1 and occ["nonportable"] == 1, (W, g, occ)


ROUNDS_BLOCKED_CASES = (
    *(f"{c}/{split}" for c in ROUNDS_CASES[:12] for split in ("1", "2:0", "2:1")),
    "exp7_all_queued/1", "node0_beside_padding/1", "node0_beside_padding/2:0",
    "ragged-best", "ragged-first", "exp5-best", "exp5-first", "exp7-best", "exp7-first")


def _rounds_blocked_cases():
    from repro_torch.kernel_bench import blocked_rounds_shapes, rounds_blocked_edge_cases

    return {**rounds_blocked_edge_cases(), **blocked_rounds_shapes()}


@pytest.mark.parametrize("case", ROUNDS_BLOCKED_CASES)
def test_bitmap_fit_rounds_blocked_matches_plain(dev, case):
    """One launch a call, bit-equal to the plain version on CPU copies, at
    the corner cases on one rank's block and on each of two ranks', and at
    the ragged, Exp5 (20 x 301) and Exp7 (253 x 307) blocks under both
    policies; for the NaN case also to the plain version on the card."""
    args, kw = _rounds_blocked_cases()[case]
    counters = (bitmap_fit.bitmap_fit_rounds_blocked, bitmap_fit.bitmap_fit_rounds,
                bitmap_fit.bitmap_fit_blocked, bitmap_fit.bitmap_fit)
    before = [c.launches for c in counters]
    want, got = _both(bitmap_fit.bitmap_fit_rounds_blocked, args, kw, dev)
    assert [c.launches - b for c, b in zip(counters, before)] == [1, 0, 0, 0]
    for name, w, g in zip(("winner", "feas", "alloc"), want, got):
        torch.testing.assert_close(g, w, rtol=0, atol=0, msg=name)
    if case.startswith("nan"):
        plain_cuda = bitmap_fit.bitmap_fit_rounds_blocked_ref(*[a.to(dev) for a in args], **kw)
        for name, w, g in zip(("winner", "feas", "alloc"), plain_cuda, got):
            torch.testing.assert_close(g, w.cpu(), rtol=0, atol=0, msg=name)
    if "/2" not in case:  # one rank's block holds every node: someone wins
        assert int((want[0] >= 0).sum()) > 0


def test_bitmap_fit_rounds_blocked_is_one_device_kernel(dev):
    """A call captured in a CUDA graph is one kernel node and nothing else."""
    from repro_torch.kernel_bench import blocked_rounds_shapes, graph_nodes

    args, kw = blocked_rounds_shapes()["exp5-best"]
    args = [a.to(dev) for a in args]
    nodes = graph_nodes(lambda: bitmap_fit.bitmap_fit_rounds_blocked(*args, **kw))
    assert nodes == {"kernel": 1, "memcpy": 0, "memset": 0, "other": 0}, nodes


def test_bitmap_fit_rounds_blocked_cluster_fits_the_card(dev):
    """At every shape of kernel_contract.GEOMETRIES as one rank's block, and
    for 1 to 8 words a node, the blocked kernel's one cluster can be
    resident with the non-portable attribute."""
    from repro_torch.analysis.kernel_contract import GEOMETRIES
    from repro_torch.kernels.bitmap_fit import ops as bops
    from repro_torch.kernels.bitmap_fit import plan as bp

    for W in (1, 2, 3, 8):
        for g in GEOMETRIES.values():
            p = bp.rounds_blocked_plan(g["P"], g["N"], g["Z"], g["M"], W, 3, 32 * W)
            occ = bops.rounds_cluster_occupancy(p)
            assert occ["clusters"] >= 1 and occ["nonportable"] == 1, (W, g, occ)


@pytest.mark.parametrize("P,K", [(1, 4), (777, 8), (65536, 8)])
def test_utility_topk_matches_plain(dev, P, K):
    rng = np.random.default_rng(P * K)
    s = torch.from_numpy(rng.uniform(0, 64, (P, K)).astype(np.float32))
    h = torch.from_numpy(rng.uniform(0, 32, (P, K)).astype(np.float32))
    eps = torch.from_numpy(rng.normal(0, 0.5, (P, K)).astype(np.float32))
    feas = torch.from_numpy(rng.integers(0, 2, (P, K)).astype(bool))
    (wi, wv), (gi, gv) = _both(utility_topk.utility_topk, (s, h, eps, feas, 1.0), {}, dev)
    # the CPU log2 and CUDA's log2f may differ by an ulp: values to rtol
    # 1e-5, indices exactly (no near-ties at these inputs)
    torch.testing.assert_close(gi, wi, rtol=0, atol=0)
    torch.testing.assert_close(gv, wv, rtol=1e-5, atol=1e-5)


def test_utility_topk_equals_torch_cuda_ops(dev):
    """The kernel's score is bit-equal to PyTorch's own CUDA elementwise ops
    (IEEE log2f, every op rounded on its own)."""
    from repro_torch.core.utility import unified_utility

    rng = np.random.default_rng(5)
    P, K = 65536, 8
    s = torch.from_numpy(rng.uniform(0, 64, (P, K)).astype(np.float32)).to(dev)
    h = torch.from_numpy(rng.uniform(0, 32, (P, K)).astype(np.float32)).to(dev)
    eps = torch.from_numpy(rng.normal(0, 0.5, (P, K)).astype(np.float32)).to(dev)
    feas = torch.ones((P, K), dtype=torch.bool, device=dev)
    best, val = utility_topk.utility_topk(s, h, eps, feas, 1.0)
    want = (unified_utility(s, h, 1.0) + eps).gather(1, best[:, None].long())[:, 0]
    torch.testing.assert_close(val, want, rtol=0, atol=0)


_ADDRESS_CASES = ["exp5", "exp7", *address_edge_cases()]


@pytest.mark.parametrize("case", _ADDRESS_CASES)
def test_utility_topk_address_matches_plain(dev, case):
    """The addressing step in one launch equals its plain version on the
    CPU on every output, the patience and the counts included, bit for bit:
    random tables at Exp5's and Exp7's shapes and every corner of
    ``kernel_bench.address_edge_cases``."""
    if case == "exp5":
        args, kw = address_inputs(5000, 65536, seed=5), address_kw()
    elif case == "exp7":
        args, kw = address_inputs(65536, 131072, Z=253, seed=7), address_kw()
    else:
        args, kw = address_edge_cases()[case]
    n0 = utility_topk.utility_topk_address.launches
    want, got = _both(utility_topk.utility_topk_address, args, kw, dev)
    assert utility_topk.utility_topk_address.launches == n0 + 1
    for name, g, w in zip(("st", "node", "zone", "timer", "patience", "counts"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        bad = (g != w).nonzero()
        assert len(bad) == 0, (name, len(bad), bad[:5].flatten().tolist())


def test_utility_topk_address_zeroes_its_counts_and_writes_no_input(dev):
    args, kw = address_edge_cases()["all_addressing"]
    on_card = [a.to(dev) for a in args]
    before = [a.clone() for a in on_card]
    first = utility_topk.utility_topk_address(*on_card, **kw)
    second = utility_topk.utility_topk_address(*on_card, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert all(torch.equal(a, b) for a, b in zip(on_card, before))
    assert int(first[-1][0].item()) == args[0].shape[0]


def test_utility_topk_address_is_one_kernel_node(dev):
    """An unbatched addressing call captured in a CUDA graph is one kernel
    node, the address kernel's, with no memset (its counts are written by
    the kernel); replays of the graph keep giving the plain version's
    counts."""
    from repro_torch.kernel_bench import graph_nodes

    args, kw = address_inputs(5000, 65536, seed=5), address_kw()
    want = utility_topk.utility_topk_address(*args, **kw)
    on_card = [a.to(dev) for a in args]
    names = []
    nodes = graph_nodes(lambda: utility_topk.utility_topk_address(*on_card, **kw), names)
    assert nodes == {"kernel": 1, "memcpy": 0, "memset": 0, "other": 0}, nodes
    assert len(names) == 1 and "utility_topk_address_kernel" in names[0], names
    for _ in range(3):
        got = utility_topk.utility_topk_address(*on_card, **kw)
        assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))


def test_utility_topk_address_counts_on_two_streams_at_once(dev):
    """Launches on two streams, interleaved with no wait between them, sum
    their counts in a region of their own each: every launch's counts equal
    the plain version's (one shared region would mix them)."""
    args, kw = address_inputs(5000, 65536, seed=5), address_kw()
    want = utility_topk.utility_topk_address(*args, **kw)[-1]
    on_card = [a.to(dev) for a in args]
    streams = [torch.cuda.Stream(dev) for _ in range(2)]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream(dev))
    got = []
    for _ in range(16):
        for s in streams:
            with torch.cuda.stream(s):
                got.append(utility_topk.utility_topk_address(*on_card, **kw)[-1])
    torch.cuda.synchronize()
    assert all(torch.equal(g.cpu(), want) for g in got)


@pytest.mark.parametrize("select", [None, 40, 41])
@pytest.mark.parametrize("Z,M", [(1, 8), (3, 13), (20, 301), (33, 257), (253, 307)])
def test_zone_aggregate_members_matches_plain(dev, Z, M, select):
    """The TEG refresh in one launch against its plain version: the sums to
    rtol 1e-5 (another summation order), the old table exactly off a
    refresh tick (t = 41, every 20)."""
    from repro_torch.core.state import densify_zones

    rng = np.random.default_rng(Z * M)
    counts = rng.integers(1, M + 1, Z).astype(np.int32)
    counts[0] = M
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    member, mask = (torch.from_numpy(a) for a in densify_zones(starts, counts))
    N = int(counts.sum())
    rep_S = torch.from_numpy(rng.integers(0, 65, N).astype(np.float32))
    rep_H = torch.from_numpy(rng.uniform(0, 12, N).astype(np.float32))
    args = (rep_S, rep_H, member, mask)
    if select is not None:
        args += (torch.tensor(select, dtype=torch.int32),
                 torch.from_numpy(rng.uniform(0, 64, Z).astype(np.float32)),
                 torch.from_numpy(rng.uniform(0, 64, Z).astype(np.float32)))
    n0 = zone_aggregate.zone_aggregate_members.launches
    want, got = _both(zone_aggregate.zone_aggregate_members, args, dict(every=20), dev)
    assert zone_aggregate.zone_aggregate_members.launches == n0 + 1
    for g, w in zip(got, want):
        tol = 0.0 if select == 41 else 1e-5
        torch.testing.assert_close(g, w, rtol=tol, atol=0)


@pytest.mark.parametrize("Z,M", [(1, 8), (20, 301), (33, 257)])
def test_zone_aggregate_matches_plain(dev, Z, M):
    rng = np.random.default_rng(Z * M)
    sg = torch.from_numpy(rng.uniform(0, 64, (Z, M)).astype(np.float32))
    hg = torch.from_numpy(rng.uniform(0, 8, (Z, M)).astype(np.float32))
    mask = torch.from_numpy((rng.uniform(size=(Z, M)) < 0.7).astype(np.float32))
    (ws, wh), (gs, gh) = _both(zone_aggregate.zone_aggregate, (sg, hg, mask), {}, dev)
    # a different summation order: rtol 1e-5, the JAX package's own bound
    torch.testing.assert_close(gs, ws, rtol=1e-5, atol=0)
    torch.testing.assert_close(gh, wh, rtol=1e-5, atol=0)


def _survival_args(seed, P, N):
    rng = np.random.default_rng(seed)
    st = rng.choice([0, 4, RUNNING, SUSPENDED], size=P, p=[0.3, 0.2, 0.35, 0.15])
    t = lambda a, dt: torch.from_numpy(np.asarray(a).astype(dt))
    return (
        t(st, np.int32),
        t(np.where(rng.uniform(size=P) < 0.8, rng.integers(0, N, P), -1), np.int32),
        t(rng.uniform(0, 0.4, P), np.float32),
        t(rng.choice([24.0, 48.0, 64.0, 128.0], P), np.float32),
        t(rng.integers(0, 3, P), np.int32),
        t(rng.uniform(size=P) < 0.2, bool),
        t(rng.integers(0, 50, P), np.int32),
        t(rng.integers(0, 120, P), np.int32),
        t(rng.uniform(0, 0.7, N), np.float32),
        torch.tensor(100, dtype=torch.int32),
    )


EDGE_CASES = ("zero_ties", "inf_scores", "fifth_on_one", "all_empty", "all_on_one", "exp7")


@pytest.mark.parametrize("airlock", [False, True])
@pytest.mark.parametrize("case", ["1x1", "777x33", "2000x7", "65536x5000", *EDGE_CASES])
def test_survival_scan_matches_plain(dev, airlock, case):
    """One cluster launch a call, bit-equal to the plain version, at random
    tables and at the design's corners (``repro_torch.kernel_bench.
    edge_cases``): scores tied at -0.0 / +0.0, +-inf scores, one node with a
    fifth of the slots, an empty table, every slot on one node, and Exp7's
    shape (131 072 slots on 65 536 nodes)."""
    from repro_torch.kernel_bench import edge_cases

    if case in EDGE_CASES:
        args = edge_cases()[case]
    else:
        P, N = map(int, case.split("x"))
        args = _survival_args(P + N, P, N)
    kw = dict(
        airlock=airlock, residual=0.3, watermark=0.9 if airlock else 1.0,
        safe=0.8, t_susp=80, t_surv=240,
    )
    n0 = survival_scan.survival_scan.launches
    want, got = _both(survival_scan.survival_scan, args, kw, dev)
    assert survival_scan.survival_scan.launches == n0 + 1
    for name, w, g in zip(("pressure", "victim", "resume", "react", "expire"), want, got):
        # pressure is summed in slot order on both sides: bit-equal
        torch.testing.assert_close(g, w, rtol=0, atol=0, msg=name)


def test_survival_scan_is_one_device_kernel(dev):
    """A call captured in a CUDA graph is one kernel node, the survival
    scan's (its function name through ``cuFuncGetName``), and nothing else."""
    from repro_torch.kernel_bench import graph_nodes

    args = [a.to(dev) for a in _survival_args(3, 65536, 5000)]
    kw = dict(airlock=True, residual=0.3, watermark=0.9, safe=0.8, t_susp=80, t_surv=240)
    names = []
    nodes = graph_nodes(lambda: survival_scan.survival_scan(*args, **kw), names)
    assert nodes == {"kernel": 1, "memcpy": 0, "memset": 0, "other": 0}, nodes
    assert len(names) == 1 and "survival_scan" in names[0], names


def test_wrapper_raises_on_wrong_dtype(dev):
    words = torch.zeros((4, 2), dtype=torch.int64, device=dev)
    with pytest.raises(ValueError):
        bitmap_fit.bitmap_fit(words, torch.zeros(4, dtype=torch.int32, device=dev),
                              torch.zeros(4, dtype=torch.bool, device=dev))


SMALL_EXP5 = LaminarConfig(
    num_nodes=64, zone_size=32, probe_capacity=1024, max_arrivals_per_tick=64,
    horizon_ms=200.0, rho=0.8, memory=MemoryConfig(enabled=True),
)


@pytest.mark.parametrize("airlock", [False, True])
def test_engine_cuda_matches_cpu(dev, airlock):
    """The engine on the card (kernels) against the engine on the CPU (plain
    versions), fed the same draws from one CPU generator, for 100 ticks."""
    cfg = dataclasses.replace(SMALL_EXP5, airlock=airlock)
    outs = []
    for device in ("cpu", dev):
        eng = LaminarEngine(cfg, device=device)
        s, lam = eng.init(0)
        draws = TorchDraws(cfg, lam, s.zstart.shape[0], seed=0, device=device,
                           generator_device="cpu")
        outs.append(eng.run(seed=0, num_ticks=100, draws=draws))
    for f in outs[0]["timeseries"]:
        np.testing.assert_array_equal(outs[1]["timeseries"][f], outs[0]["timeseries"][f], err_msg=f)
    assert outs[0]["started"] > 0


def _run_launches(run, lockstep=False):
    """``run()``'s hand-written launches: a compiled run's graph kernel
    nodes (``kernel_bench.graph_census``) times its replays, by entry."""
    from repro_torch.core.scan import watching
    from repro_torch.kernel_bench import graph_census, tick_entries

    with watching() as runs:
        out = run()
    torch.cuda.synchronize()
    launches = {}
    for compiled, replays in runs:
        for entry, n in tick_entries(graph_census(compiled.graph)["names"], lockstep).items():
            launches[entry] = launches.get(entry, 0) + n * replays
    return out, launches


def test_flat_tick_launches_bitmap_fit_rounds_once(dev):
    """The flat tick runs its arbitration rounds as one bitmap_fit_rounds
    launch and never the one-round bitmap_fit: the captured tick's graph
    holds one bitmap_fit_rounds kernel node, replayed once a tick."""
    cfg = dataclasses.replace(SMALL_EXP5, airlock=True)
    eng = LaminarEngine(cfg, device=dev)
    s, lam = eng.init(0)
    draws = eng.draws(lam, s.zstart.shape[0], 0)
    _, launches = _run_launches(lambda: eng.simulate(s, draws, 30))
    assert launches == {"bitmap_fit_rounds": 30, "utility_topk_address": 30,
                        "zone_aggregate_members": 30, "survival_scan": 30}


@pytest.fixture
def nccl1(dev, tmp_path):
    """A one-rank NCCL process group in this process (FileStore, no port),
    destroyed after the test, once its graphs are gone."""
    import gc

    import torch.distributed as dist

    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        yield
    finally:
        gc.collect()
        torch.cuda.synchronize()
        dist.destroy_process_group()


def test_sharded_tick_launches_bitmap_fit_rounds_blocked_once(dev, nccl1):
    """The zone-sharded tick (one NCCL rank) runs its arbitration rounds as
    one bitmap_fit_rounds_blocked launch, never a one-round entry (its
    captured graph's kernel nodes times its replays), and equals the flat
    engine on the card."""
    from repro_torch.parallel.engine_mesh import ZoneShardedEngine

    cfg = dataclasses.replace(SMALL_EXP5, airlock=True)
    mesh = ZoneShardedEngine(cfg, device=dev)
    got, launches = _run_launches(lambda: mesh.run(seed=0, num_ticks=30))
    assert launches == {"bitmap_fit_rounds_blocked": 30, "utility_topk_address": 30,
                        "zone_aggregate_members": 30, "survival_scan": 30}
    want = LaminarEngine(cfg, device=dev).run(seed=0, num_ticks=30)
    for f in want["timeseries"]:
        np.testing.assert_array_equal(got["timeseries"][f], want["timeseries"][f], err_msg=f)
    assert want["started"] > 0


# ---------------------------------------------------------------------------
# launch plans on the card: block_copy and the compiled attributes
# ---------------------------------------------------------------------------

BAND = 256


def _in_band(n, dev, fill):
    buf = torch.full((n + 2 * BAND,), fill, dtype=torch.float32, device=dev)
    return buf[BAND:BAND + n], buf


@pytest.mark.parametrize("grid,offset", [(8, 0), (7, 0)])
def test_block_copy_matches_plan_interpreter(dev, grid, offset):
    """block_copy under the good plan and the tail-dropping plan equals the
    plan interpreter; the unwritten tail stays NaN on both sides."""
    from repro_torch.kernels.block_copy import block_copy, block_copy_ref
    from repro_torch.kernels.block_copy.plan import plan

    p = plan(1024, 128, grid, offset)
    x = torch.from_numpy(np.random.default_rng(grid).normal(size=1024).astype(np.float32))
    n0 = block_copy.launches
    got = block_copy(x.to(dev), p).cpu()
    assert block_copy.launches == n0 + 1
    want = block_copy_ref(x, p)
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


def _copy_plans():
    import importlib.util
    from pathlib import Path

    from repro_torch.kernels.block_copy.plan import good_plan

    path = Path(__file__).resolve().parent / "fixtures" / "torch_analysis" / "bad_launch_tail.py"
    spec = importlib.util.spec_from_file_location("bad_launch_tail", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return {"good": good_plan(1024, 128), **{k: p for k, (p, _) in mod.PLANS.items()}}


@pytest.mark.parametrize("name", ["good", "tail_dropping_grid", "index_map_overshoot",
                                  "vmem_over_budget"])
def test_block_copy_is_one_device_kernel(dev, name):
    """A call is one kernel under every plan (its NaN tail filled in the same
    launch: no memset node), and equals the plan interpreter where the plan
    stays inside x, NaN tail included."""
    from repro_torch.kernel_bench import graph_nodes
    from repro_torch.kernels.block_copy import block_copy, block_copy_ref

    p = _copy_plans()[name]
    x = torch.from_numpy(np.random.default_rng(5).normal(size=1024).astype(np.float32)).to(dev)
    nodes = graph_nodes(lambda: block_copy(x, p))
    assert nodes == {"kernel": 1, "memcpy": 0, "memset": 0, "other": 0}, nodes
    got = block_copy(x, p)
    if name != "index_map_overshoot":  # that one reads past x (see below)
        torch.testing.assert_close(got.cpu(), block_copy_ref(x.cpu(), p), rtol=0, atol=0,
                                   equal_nan=True)


def test_block_copy_overshoot_reads_past_the_end(dev):
    """Under the overshoot plan the kernel's last block reads the guard band
    after x, where the interpreter clamps to x's last block."""
    from repro_torch.kernels.block_copy import block_copy_ref
    from repro_torch.kernels.block_copy import ops as copy_ops
    from repro_torch.kernels.block_copy.plan import plan

    p = plan(1024, 128, 8, 1)
    x, _ = _in_band(1024, dev, -7.5)
    x.copy_(torch.arange(1024, dtype=torch.float32, device=dev))
    out, obuf = _in_band(1024, dev, float("nan"))
    copy_ops.launch(p, (out,), x)
    torch.cuda.synchronize()
    got, want = out.cpu(), block_copy_ref(x.cpu(), p)
    torch.testing.assert_close(got[:896], want[:896], rtol=0, atol=0)
    assert bool((got[896:] == -7.5).all())
    torch.testing.assert_close(want[896:], x.cpu()[896:], rtol=0, atol=0)
    assert bool(torch.isnan(obuf[:BAND]).all() and torch.isnan(obuf[-BAND:]).all())


def test_compiled_attributes_match_plans(dev):
    """Each kernel's static shared memory equals its plan's declaration, and
    every plan at the reference shapes fits the per-block budget."""
    from repro_torch.analysis.kernel_contract import GEOMETRIES, PER_BLOCK, kernel_suite
    from repro_torch.kernels import PLANS, _build
    from repro_torch.kernels.bitmap_fit import plan as bp
    from repro_torch.kernels.block_copy import plan as cp
    from repro_torch.kernels.survival_scan import plan as sp
    from repro_torch.kernels.utility_topk import plan as tp
    from repro_torch.kernels.zone_aggregate import plan as ap

    attrs = {}
    for mod in (bp, tp, ap, sp, cp):
        for k, kernel in enumerate(mod.KERNELS):
            attrs[kernel] = _build.attrs(mod.__name__.split(".")[-2], k)
    plans = [PLANS[name](*args, **kw) for geom in GEOMETRIES.values()
             for name, args, kw, _ in kernel_suite(geom)] + [cp.good_plan(1024, 128)]
    for p in plans:
        for L in p.launches:
            a = attrs[L.kernel]
            assert a["static_smem"] == L.static_smem, (L.kernel, a)
            assert a["static_smem"] + L.dynamic_smem <= PER_BLOCK["smem"]
            assert L.block <= a["max_threads"]


def test_survival_scan_cluster_fits_the_card(dev):
    """At every shape of kernel_contract.GEOMETRIES the one cluster can be
    resident, with the plan's dynamic shared memory and, past 8 CTAs, the
    non-portable attribute; its registers fit 1024 threads a block."""
    from repro_torch.analysis.kernel_contract import GEOMETRIES
    from repro_torch.kernels import _build
    from repro_torch.kernels.survival_scan import ops as sops
    from repro_torch.kernels.survival_scan import plan as sp

    regs = _build.attrs("survival_scan", 0)["registers"]
    assert regs * sp.THREADS <= 65536, regs
    for g in GEOMETRIES.values():
        p = sp.plan(g["P"], g["N"], True)
        (L,) = p.launches
        occ = sops.cluster_occupancy(p)
        assert occ["clusters"] >= 1, (g, occ)
        assert occ["max_dynamic_smem"] >= L.dynamic_smem, (g, occ)
        assert occ["nonportable"] == int(L.cluster > 8), occ


def test_launcher_refuses_a_block_it_was_not_built_for(dev):
    """The grid and block come from the plan; a block other than the
    compiled one is refused (cudaErrorInvalidConfiguration)."""
    import dataclasses as dc

    from repro_torch.kernels.bitmap_fit import ops as bops

    words = torch.zeros((300, 2), dtype=torch.int32, device=dev)
    mass = torch.zeros(300, dtype=torch.int32, device=dev)
    contig = torch.zeros(300, dtype=torch.bool, device=dev)
    good = bops._plan.for_call(words, mass, contig)
    bad = dc.replace(good, launches=(dc.replace(good.launches[0], block=128),))
    with pytest.raises(RuntimeError, match="cudaError 9"):
        bops.launch(bad, bad.new_outputs(dev), words, mass, contig)


@pytest.mark.parametrize("scenario", ["stationary", "storm"])
@pytest.mark.parametrize("name", ["slurm", "ray", "flux"])
def test_baseline_equals_cpu_run(dev, name, scenario):
    """A baseline model on the card and on the CPU with one CPU generator's
    draws: every metric, the per-tick series and the final state equal (no
    kernel: plain PyTorch ops, XLA's float32 rounding rebuilt from IEEE
    operations that round alike on both devices)."""
    from repro_torch.core import BaselineConfig
    from repro_torch.core.baselines import common as C
    from repro_torch.core.baselines import flux_like, ray_like, slurm_like
    from repro_torch.core.baselines.draws import TorchBaselineDraws
    from repro_torch.workloads import SCENARIOS

    mod = {"slurm": slurm_like, "ray": ray_like, "flux": flux_like}[name]
    cfg = LaminarConfig(num_nodes=64, zone_size=32, probe_capacity=1024,
                        max_arrivals_per_tick=64, horizon_ms=100.0, rho=0.8,
                        scenario=SCENARIOS[scenario])
    runs = []
    for device in ("cpu", dev):
        s, lam = mod.init(cfg, 0, 1 << 12, device)
        draws = TorchBaselineDraws(name, cfg, lam, 1 << 12, 0, device, generator_device="cpu")
        final, ys = C.simulate(mod.make_step(cfg, BaselineConfig()), s, draws, cfg.num_ticks)
        runs.append((C.state_to_numpy(final), ys.cpu().numpy()))
    (a, ya), (b, yb) = runs
    np.testing.assert_array_equal(ya, yb)

    def flat(d, path=""):
        for k, v in d.items():
            yield from flat(v, f"{path}{k}.") if isinstance(v, dict) else [(path + k, v)]

    for (k, x), (_, y) in zip(flat(a), flat(b)):
        assert x.tobytes() == y.tobytes(), k
    assert int(a["metrics"]["started"]) > 0


# ---------------------------------------------------------------------------
# the LM serving path (plain PyTorch, no hand-written kernel)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,B", [(2048, 1), (24, 2)])
def test_full_width_decode_matches_forward(dev, S, B, compute):
    """qwen3-1.7b at full width: prefill(S - 1) plus one decode_step gives
    forward's last logits; S = 2048 takes the streaming attention path,
    S = 24 the dense one. rtol = atol = 0.05 (tests/test_models.py's), but
    bfloat16 at S = 2048, where the two paths' bfloat16 roundings over 2047
    positions part by up to 0.09 at a logit scale of 8.5 (float32: 2e-5):
    2**-5 of the scale, the CPU parity tests' bfloat16 bound."""
    from repro_torch.configs import get
    from repro_torch.models import lm

    cfg = dataclasses.replace(get("qwen3-1.7b"), compute_dtype=getattr(torch, compute))
    with torch.inference_mode():
        p = lm.init_params(cfg, 0, dev)
        tok = torch.randint(0, cfg.vocab, (B, S), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(S))
        want = lm.forward(cfg, p, tok)[0][:, -1]
        caches = lm.init_cache(cfg, B, S + 4, dev)
        _, caches = lm.prefill(cfg, p, tok[:, : S - 1], caches)
        got = lm.decode_step(cfg, p, tok[:, S - 1:], S - 1, caches)[0][:, 0]
    assert torch.isfinite(got).all()
    if compute == "bfloat16" and S == 2048:
        assert float((got - want).abs().max()) <= 2.0**-5 * float(want.abs().max())
    else:
        torch.testing.assert_close(got, want, rtol=0.05, atol=0.05)


def test_two_layers_cuda_matches_cpu(dev):
    """qwen3-1.7b's full width cut to 2 layers, the same parameters on both
    devices: logits within 2**-5 of their scale, and the greedy tokens equal
    wherever the CPU's top-2 margin exceeds the largest difference."""
    from repro_torch.configs import get
    from repro_torch.models import blocks, lm

    cfg = get("qwen3-1.7b").scaled(n_layers=2)
    with torch.inference_mode():
        p = lm.init_params(cfg, 1, dev)
        tok = torch.randint(0, cfg.vocab, (2, 32), generator=torch.Generator().manual_seed(2))
        want = lm.forward(cfg, blocks.tree_map(lambda a: a.cpu(), p), tok)[0]
        got = lm.forward(cfg, p, tok.to(dev))[0].cpu()
    diff = float((got - want).abs().max())
    assert diff <= 2.0**-5 * float(want.abs().max())
    top2 = torch.topk(want, 2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > diff
    assert torch.equal(got.argmax(-1)[clear], want.argmax(-1)[clear])


@pytest.mark.parametrize("router", ["topk", "laminar"])
def test_moe_dropped_slots_equal_cpu(dev, router):
    """olmoe-1b-7b's MoE layer at full width, 2048 tokens of
    bench_moe_router.py's skewed traffic: the dropped-slot counts, loads and
    each round's experts on the card equal the CPU's."""
    from repro_torch.configs import get
    from repro_torch.models import blocks, moe

    cfg = get("olmoe-1b-7b")
    p = moe.init_moe_params(torch.Generator(device=dev).manual_seed(0), cfg)
    pc = blocks.tree_map(lambda a: a.cpu(), p)
    g = torch.Generator().manual_seed(0)
    base, noise = torch.randn((1, 1, 2048), generator=g), torch.randn((1, 2048, 2048), generator=g)
    for skew in (0.0, 0.9):
        x = (skew * base + (1 - skew) * noise).bfloat16()
        for capacity in (0.5, 1.5):
            c = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, router=router, capacity_factor=capacity, laminar_bounces=2))
            with torch.inference_mode():
                _, ad = moe.moe_ffn(p, c, x.to(dev))
                _, ac = moe.moe_ffn(pc, c, x)
                pd = moe.route(p, c, x.reshape(-1, 2048).to(dev))[0]
                pcpu = moe.route(pc, c, x.reshape(-1, 2048))[0]
            assert int(ad["moe_dropped_slots"]) == int(ac["moe_dropped_slots"])
            assert torch.equal(ad["moe_load"].cpu(), ac["moe_load"])
            for a, b in zip(pd, pcpu):
                assert torch.equal(a.expert.cpu(), b.expert) and torch.equal(a.kept.cpu(), b.kept)


def test_serve_cli_runs_on_the_card(dev, capsys):
    """``python -m repro_torch.launch.serve --arch qwen3-1.7b`` at full width,
    on the card by default; its stats are the CPU --smoke run's."""
    from repro_torch.launch import serve as tserve

    tserve.main(["--arch", "qwen3-1.7b"])
    out = capsys.readouterr().out.splitlines()
    tserve.main(["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu"])
    smoke = capsys.readouterr().out.splitlines()
    assert out[0].startswith("arch=qwen3-1.7b replicas=2 arrived=24")
    assert out[0] == smoke[0]


def test_router_argmax_ties_match_cpu(dev):
    """torch.argmax on the card takes the lowest index on ties and on an
    all -inf row, as on the CPU (and as jnp.argmax)."""
    rows = torch.tensor([[1.0, 3.0, 3.0, 0.0], [-float("inf")] * 4, [2.0] * 4,
                         [-float("inf"), -float("inf"), 5.0, 5.0]])
    wide = torch.full((4096, 64), -float("inf"))
    wide[::3, 7] = wide[::3, 40] = 1.0
    for x in (rows, wide):
        assert torch.equal(torch.argmax(x.to(dev), dim=-1).cpu(), torch.argmax(x, dim=-1))
    assert torch.argmax(rows.to(dev), dim=-1).tolist() == [1, 0, 0, 2]


# ---------------------------------------------------------------------------
# the training path and the RG-LRU / SSD blocks (plain PyTorch, no kernel)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "olmoe-1b-7b", "recurrentgemma-2b",
                                  "mamba2-130m"])
def test_train_step_cuda_matches_cpu(dev, arch):
    """Three train steps at smoke width in float32 compute, the same
    parameters and batches on both devices: losses within 1e-5, grad norms
    within 1e-4 of themselves, learning rates and dropped slots equal,
    every parameter within 0.25 lr (the CPU tests' bound against JAX)."""
    from repro_torch.configs import get_smoke
    from repro_torch.launch import steps
    from repro_torch.models import blocks, lm
    from repro_torch.train import data, optimizer

    cfg = dataclasses.replace(get_smoke(arch), compute_dtype=torch.float32)
    ocfg = optimizer.OptConfig(lr=1e-3, warmup_steps=2, total_steps=5)
    pc = lm.init_params(cfg, 0, "cpu")
    pd = blocks.tree_map(lambda a: a.to(dev), pc)
    sc, sd = optimizer.init_opt_state(ocfg, pc), optimizer.init_opt_state(ocfg, pd)
    step = steps.make_train_step(cfg, ocfg)
    it = data.PackedBatcher(data.SyntheticSource(cfg.vocab, seed=0), 2, 16)
    for b in [next(iter(it)) for _ in range(3)]:
        bc = {k: torch.from_numpy(v) for k, v in b.items()}
        pc, sc, mc = step(pc, sc, bc)
        pd, sd, md = step(pd, sd, {k: v.to(dev) for k, v in bc.items()})
        assert abs(float(md["loss"]) - float(mc["loss"])) <= 1e-5 * abs(float(mc["loss"]))
        assert abs(float(md["grad_norm"]) - float(mc["grad_norm"])) <= 1e-4 * float(mc["grad_norm"])
        assert float(md["lr"]) == float(mc["lr"])
        assert int(md["moe_dropped_slots"]) == int(mc["moe_dropped_slots"])
    for a, b in zip(optimizer.sorted_leaves(pc), optimizer.sorted_leaves(pd)):
        assert float((a - b.cpu()).abs().max()) <= 0.25 * ocfg.lr


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", ["recurrent", "ssd"])
def test_recurrent_blocks_cuda_match_cpu(dev, family, compute):
    """The RG-LRU and SSD blocks at smoke width, prefill of 37 tokens (the
    SSD chunk pads) then 3 decode steps, the same inputs on both devices:
    float32 within 1e-5 of the scale, bfloat16 within 2**-5."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import blocks, rglru, ssd

    arch = "recurrentgemma-2b" if family == "recurrent" else "mamba2-130m"
    cfg = dataclasses.replace(get_smoke(arch), compute_dtype=getattr(torch, compute))
    block, state = ((rglru.rglru_block, rglru.init_rglru_state) if family == "recurrent"
                    else (ssd.ssd_block, ssd.init_ssd_state))
    pc = blocks.init_block_params(torch.Generator().manual_seed(0), cfg, family)["mixer"]
    pd = blocks.tree_map(lambda a: a.to(dev), pc)
    tol = 1e-5 if compute == "float32" else 2.0**-5
    stc, std = state(cfg, 2, "cpu"), state(cfg, 2, dev)
    g = torch.Generator().manual_seed(1)
    for n in (37, 1, 1, 1):
        x = torch.randn((2, n, cfg.d_model), generator=g).to(cfg.compute_dtype)
        oc, stc = block(pc, cfg, x, stc)
        od, std = block(pd, cfg, x.to(dev), std)
        for a, b in [(oc, od)] + list(zip(stc, std)):
            assert torch.isfinite(b).all()
            err = float((a.float() - b.cpu().float()).abs().max())
            assert err <= tol * float(a.float().abs().max())


def test_train_cli_runs_on_the_card(dev, capsys, tmp_path):
    """``python -m repro_torch.launch.train --arch mamba2-130m --smoke`` runs
    on the card by default and prints the reference's last line."""
    from repro_torch.launch import train

    out = train.main(["--arch", "mamba2-130m", "--smoke", "--steps", "4", "--batch", "2",
                      "--seq", "16", "--ckpt-dir", str(tmp_path)])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("arch=mamba2-130m steps=4 first_loss=")
    assert np.isfinite(out["losses"]).all()


# ---------------------------------------------------------------------------
# the batched entries of the lockstep tick (a seed axis, one launch)
# ---------------------------------------------------------------------------

BATCHED_ENTRIES = ("bitmap_fit_rounds_batched", "utility_topk_address_batched",
                   "zone_aggregate_members_batched", "survival_scan_batched")
# the entries whose float outputs the card rounds as the CPU does (the
# others: the summation order of zone_aggregate, rtol 1e-5)
BATCHED_EXACT = ("survival_scan_batched", "utility_topk_address_batched",
                 "bitmap_fit_rounds_batched")


def _batched_case(name, shape, airlock=True):
    from repro_torch.kernel_bench import batched_inputs

    return batched_inputs(3, **shape, seed=11, airlock=airlock)[name]


@pytest.mark.parametrize("name", BATCHED_ENTRIES)
@pytest.mark.parametrize("shape", [dict(N=37, P=1029, Z=3), dict(N=5000, P=65536, Z=20)],
                         ids=["ragged", "exp5"])
def test_batched_entry_matches_plain_seed_by_seed(dev, name, shape):
    """B = 3 seeds with distinct inputs: one launch, equal to the plain
    version applied seed by seed (survival_scan with Airlock off too)."""
    from repro_torch.kernels import WRAPPERS

    for airlock in ((True, False) if name == "survival_scan_batched" else (True,)):
        args, kw = _batched_case(name, shape, airlock)
        n0 = WRAPPERS[name].launches
        want, got = _both(WRAPPERS[name], args, kw, dev)
        assert WRAPPERS[name].launches == n0 + 1
        for w, g in zip(want, got):
            assert g.dtype == w.dtype and g.shape == w.shape
            if w.dtype.is_floating_point and name not in BATCHED_EXACT:
                torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
            else:
                assert torch.equal(g, w)


@pytest.mark.parametrize("name", BATCHED_ENTRIES)
def test_batched_entry_is_one_kernel_node(dev, name):
    """One batched call captured in a CUDA graph is one kernel node, with no
    memset or memcpy (utility_topk_address_batched writes its counts in the
    kernel)."""
    from repro_torch.kernel_bench import graph_nodes
    from repro_torch.kernels import WRAPPERS

    args, kw = _batched_case(name, dict(N=5000, P=65536, Z=20))
    args = [a.to(dev) if isinstance(a, torch.Tensor) else a for a in args]
    names = []
    nodes = graph_nodes(lambda: WRAPPERS[name](*args, **kw), names)
    assert nodes == {"kernel": 1, "memcpy": 0, "memset": 0, "other": 0}, nodes
    # and replays of the graph keep giving the same counts (the address
    # kernel's accumulators are set back to zero by each launch)
    if name == "utility_topk_address_batched":
        first = WRAPPERS[name](*args, **kw)[-1].clone()
        for _ in range(3):
            assert torch.equal(WRAPPERS[name](*args, **kw)[-1], first)


def test_batched_clusters_run_in_waves(dev):
    """Past the clusters the card holds at once, the batched cluster
    kernels run in later waves and stay equal to the plain version."""
    from repro_torch.kernel_bench import batched_inputs
    from repro_torch.kernels import WRAPPERS
    from repro_torch.kernels.bitmap_fit import ops as bops
    from repro_torch.kernels.bitmap_fit import plan as bplan
    from repro_torch.kernels.survival_scan import ops as sops
    from repro_torch.kernels.survival_scan import plan as splan

    resident = max(sops.cluster_occupancy(splan.plan(4096, 500, True))["clusters"],
                   bops.rounds_cluster_occupancy(bplan.rounds_plan(4096, 500, 2, 3, 64))["clusters"])
    cases = batched_inputs(resident + 3, N=500, P=4096, Z=4, seed=2)
    for name in ("survival_scan_batched", "bitmap_fit_rounds_batched"):
        args, kw = cases[name]
        want, got = _both(WRAPPERS[name], args, kw, dev)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("airlock", [False, True])
def test_lockstep_engine_on_the_card(dev, airlock):
    """run_batch in lockstep on the card equals the sequential runs on the
    card, seed by seed, and its CPU twin on one CPU generator's draws; each
    batched kernel is one launch a tick."""
    from repro_torch.core.draws import BatchDraws
    from repro_torch.kernels import BATCHED, WRAPPERS

    cfg = dataclasses.replace(SMALL_EXP5, airlock=airlock)
    seeds, ticks = [0, 1, 2], 60
    eng = LaminarEngine(cfg, device=dev)
    got, launches = _run_launches(lambda: eng.run_batch(seeds, num_ticks=ticks), lockstep=True)
    assert launches == dict.fromkeys(BATCHED.values(), ticks)
    assert all(name in WRAPPERS for name in launches)
    s0, lam = eng.init(0)
    for sd, out in zip(seeds, got):
        final, ts = eng.simulate(s0, eng.draws(lam, s0.zstart.shape[0], sd), ticks)
        ts = ts.cpu().numpy()
        for i, f in enumerate(out["timeseries"]):
            np.testing.assert_array_equal(out["timeseries"][f], ts[:, i], err_msg=f)
    outs = []
    for device in ("cpu", dev):
        e = LaminarEngine(cfg, device=device)
        sb, lam = e.init_batch(seeds)
        draws = BatchDraws([TorchDraws(cfg, lam, sb.zstart.shape[1], seed=sd, device=device,
                                       generator_device="cpu") for sd in seeds])
        outs.append(e.simulate_batch(sb, draws, ticks)[1].cpu())
    assert torch.equal(outs[0], outs[1])


# ---------------------------------------------------------------------------
# the compiled run (core.scan): a tick captured once, replayed
# ---------------------------------------------------------------------------


def _eager(step, s, draws, ticks):
    rows = []
    for t in range(ticks):
        s, y = step(s, draws.tick(t))
        rows.append(y)
    return s, torch.stack(rows)


def _leaves(s):
    import torch.utils._pytree as pytree

    return pytree.tree_flatten(s)[0]


def _bits_equal(a, b):
    return all(x.dtype == y.dtype and x.shape == y.shape
               and x.cpu().numpy().tobytes() == y.cpu().numpy().tobytes()
               for x, y in zip(_leaves(a), _leaves(b)))


@pytest.mark.parametrize("airlock", [False, True])
def test_captured_run_equals_make_step_by_hand(dev, airlock):
    """The flat tick captured and replayed for 300 ticks equals make_step
    driven by hand on the card: the series and every leaf of the final
    state, bit for bit; the provider's generator ends where the eager loop
    leaves it."""
    from repro_torch.core.engine import make_step

    cfg = dataclasses.replace(SMALL_EXP5, airlock=airlock, horizon_ms=150.0)
    eng = LaminarEngine(cfg, device=dev)
    s, lam = eng.init(0)
    a, b = (eng.draws(lam, s.zstart.shape[0], 0) for _ in range(2))
    final, ts = eng.simulate(s, a, 300)
    efinal, ets = _eager(make_step(cfg), s, b, 300)
    assert torch.equal(ts, ets)
    assert _bits_equal(final, efinal)
    assert torch.equal(a.gen.get_state(), b.gen.get_state())
    assert int(ts[-1, 1]) > 0


def test_captured_lockstep_equals_make_step_by_hand(dev):
    """Lockstep B = 2 captured (the vmapped tick and both seeds' sampling in
    one graph) equals the vmapped make_step driven by hand, 300 ticks."""
    from repro_torch.core.draws import BatchDraws
    from repro_torch.core.engine import make_step

    cfg = dataclasses.replace(SMALL_EXP5, airlock=True, horizon_ms=150.0)
    eng = LaminarEngine(cfg, device=dev)
    sb, lam = eng.init_batch([0, 1])

    def draws():
        return BatchDraws([eng.draws(lam, sb.zstart.shape[1], sd) for sd in (0, 1)])

    final, ts = eng.simulate_batch(sb, draws(), 300)
    step = make_step(cfg)
    efinal, ets = _eager(lambda s, d: torch.func.vmap(step, in_dims=(0, BatchDraws.in_dims(d)))(
        s, d), sb, draws(), 300)
    assert torch.equal(ts, ets.movedim(0, 1))
    assert _bits_equal(final, efinal)


def test_captured_baseline_equals_make_step_by_hand(dev):
    """A baseline's step captured for the run (flux: the Gumbel leaf draws
    and the root choke) equals its step driven by hand, 300 ticks."""
    from repro_torch.core import BaselineConfig
    from repro_torch.core.baselines import common as C
    from repro_torch.core.baselines import flux_like
    from repro_torch.core.baselines.draws import TorchBaselineDraws

    cfg = LaminarConfig(num_nodes=64, zone_size=32, probe_capacity=1024,
                        max_arrivals_per_tick=64, horizon_ms=150.0, rho=0.9)
    s, lam = flux_like.init(cfg, 0, 1 << 12, dev)
    step = flux_like.make_step(cfg, BaselineConfig())
    final, ys = C.simulate(step, s, TorchBaselineDraws("flux", cfg, lam, 1 << 12, 0, dev), 300)
    efinal, eys = _eager(step, s, TorchBaselineDraws("flux", cfg, lam, 1 << 12, 0, dev), 300)
    assert torch.equal(ys, eys)
    assert _bits_equal(final, efinal)
    assert int(ys[-1, 1]) > 0


def test_lockstep_graph_holds_the_batched_entries_once(dev):
    """The captured lockstep tick's kernel nodes: each batched entry once,
    no unbatched entry, no memcpy node touching host memory."""
    from repro_torch.core.draws import BatchDraws
    from repro_torch.core.scan import watching
    from repro_torch.kernel_bench import graph_census, tick_entries
    from repro_torch.kernels import BATCHED

    eng = LaminarEngine(dataclasses.replace(SMALL_EXP5, airlock=True), device=dev)
    sb, lam = eng.init_batch([0, 1, 2])
    draws = BatchDraws([eng.draws(lam, sb.zstart.shape[1], sd) for sd in (0, 1, 2)])
    with watching() as runs:
        eng.simulate_batch(sb, draws, 5)
    ((compiled, replays),) = runs
    census = graph_census(compiled.graph)
    assert replays == 5
    assert tick_entries(census["names"], lockstep=True) == dict.fromkeys(BATCHED.values(), 1)
    assert census["host_memcpy"] == 0


def test_two_engines_keep_their_graphs_apart(dev):
    """Two engines of different configs, each with its cached graph, run in
    turns: each run equals that engine's first run from the same start."""
    engines = [LaminarEngine(SMALL_EXP5, device=dev),
               LaminarEngine(dataclasses.replace(SMALL_EXP5, airlock=True, rho=0.9), device=dev)]
    starts = [e.init(0) for e in engines]
    first = []
    for e, (s, lam) in zip(engines, starts):
        first.append(e.simulate(s, e.draws(lam, s.zstart.shape[0], 0), 60))
    for _ in range(2):
        for e, (s, lam), (fs, fts) in zip(engines, starts, first):
            fs2, fts2 = e.simulate(s, e.draws(lam, s.zstart.shape[0], 0), 60)
            assert torch.equal(fts, fts2)
            assert _bits_equal(fs, fs2)
    assert all(len(e._compiled) == 1 for e in engines)
    assert not torch.equal(first[0][1], first[1][1])


def test_captures_past_the_accumulator_pool_raise_and_dropped_graphs_give_back(dev,
                                                                              monkeypatch):
    """The address kernel's count accumulators, with the pool cut to three
    regions: the side stream's eager warm-up takes one, each captured graph
    one more; a third graph held at once is refused; dropping a graph gives
    its region back, and the next capture takes it."""
    import gc

    from repro_torch.kernels.utility_topk import ops as topk_ops
    from repro_torch.kernels.utility_topk import plan as topk_plan

    engines = [LaminarEngine(dataclasses.replace(SMALL_EXP5, rho=r), device=dev)
               for r in (0.7, 0.8, 0.9)]

    def run(e):
        s, lam = e.init(0)
        return e.simulate(s, e.draws(lam, s.zstart.shape[0], 0), 5)

    run(engines[0])  # the warm-up stream's region and a graph's, in the pool as it is
    # a copy of the regions with every gap taken, and the pool cut one region past them
    device = torch.cuda.current_device()
    regions = dict(topk_ops._acc_regions)
    spans = [(off, off + 4 * key[3]) for key, off in regions.items() if key[0] == device]
    end = max(hi for _, hi in spans)
    for off in range(0, end, 4):
        if not any(lo <= off < hi for lo, hi in spans):
            regions[(device, -1 - off, 0, 1)] = off
    monkeypatch.setattr(topk_ops, "_acc_regions", regions)
    monkeypatch.setattr(topk_plan, "ACC_POOL_WORDS", end + 4)
    run(engines[1])  # the pool's last region
    with pytest.raises(RuntimeError, match="no count accumulator left"):
        run(engines[2])
    engines[1]._compiled.clear()
    gc.collect()
    run(engines[2])
    assert len(engines[2]._compiled) == 1


# ---------------------------------------------------------------------------
# the compiled sharded run and the compiled decode step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("airlock", [False, True])
def test_captured_sharded_run_equals_make_step_by_hand(dev, nccl1, airlock):
    """The zone-sharded tick captured with its NCCL gathers (world size 1)
    and replayed for 300 ticks equals make_step with the engine's mesh
    plane driven by hand: the series and every leaf of the final state, bit
    for bit; the graph holds each hand-written entry once a tick."""
    from repro_torch.core.engine import make_step
    from repro_torch.core.scan import watching
    from repro_torch.kernel_bench import graph_census, tick_entries
    from repro_torch.parallel.engine_mesh import ZoneShardedEngine

    cfg = dataclasses.replace(SMALL_EXP5, airlock=airlock, horizon_ms=150.0)
    eng = ZoneShardedEngine(cfg, device=dev)
    s, lam = eng.init(0)
    a, b = (eng.draws(lam, s.zstart.shape[0], 0) for _ in range(2))
    with watching() as runs:
        final, ts = eng.simulate(s, a, 300)
    efinal, ets = _eager(make_step(cfg, plane=eng._plane(s)), s, b, 300)
    assert torch.equal(ts, ets)
    assert _bits_equal(final, efinal)
    assert torch.equal(a.gen.get_state(), b.gen.get_state())
    assert int(ts[-1, 1]) > 0
    ((compiled, replays),) = runs
    census = graph_census(compiled.graph)
    assert replays == 300
    assert tick_entries(census["names"], lockstep=False) == {
        "bitmap_fit_rounds_blocked": 1, "utility_topk_address": 1,
        "zone_aggregate_members": 1, "survival_scan": 1}
    assert census["host_memcpy"] == 0


def _smoke_decode(dev, arch="qwen3-1.7b"):
    from repro_torch.configs import get_smoke
    from repro_torch.launch import serve
    from repro_torch.models import lm

    cfg = get_smoke(arch)
    return cfg, lm.init_params(cfg, 0, dev), serve.CompiledDecode


# every smoke arch whose decode_step the serve driver runs (whisper-base
# needs its encoder frames, in both packages)
DECODING = ["qwen2.5-32b", "gemma2-9b", "qwen3-1.7b", "qwen1.5-110b", "olmoe-1b-7b",
            "phi3.5-moe-42b-a6.6b", "recurrentgemma-2b", "qwen2-vl-7b", "mamba2-130m"]


@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("arch", DECODING)
def test_captured_decode_equals_eager(dev, arch, B):
    """The serve driver's decode captured for B (smoke width) equals eager
    ``lm.decode_step`` from a fresh cache bit for bit, at three positions
    replayed through one graph (95: the cache's last slot, past every
    local ring), for every arch the driver decodes: the MoE routing, the
    RG-LRU / SSD states and M-RoPE capture with no host value."""
    from repro_torch.launch.serve import S_MAX
    from repro_torch.models import lm

    cfg, params, CompiledDecode = _smoke_decode(dev, arch)
    dec = CompiledDecode(cfg, params)
    tok = torch.randint(0, cfg.vocab, (B, 1), device=dev, dtype=torch.int32)
    with torch.inference_mode():
        for at in (4, 50, 95):
            got = dec(tok, at).clone()
            want, _ = lm.decode_step(cfg, params, tok, at, lm.init_cache(cfg, B, S_MAX, dev))
            assert torch.equal(got, want), at
    assert dec.steps[B].graph is not None


def test_decode_graphs_of_two_batch_sizes_stay_apart(dev):
    """B = 1 and B = 2 in turns through one CompiledDecode: each call equals
    the eager step, two graphs, each replay leaving the other's output."""
    from repro_torch.launch.serve import S_MAX
    from repro_torch.models import lm

    cfg, params, CompiledDecode = _smoke_decode(dev)
    dec = CompiledDecode(cfg, params)
    toks = {B: torch.randint(0, cfg.vocab, (B, 1), device=dev, dtype=torch.int32)
            for B in (1, 2)}
    with torch.inference_mode():
        want = {B: lm.decode_step(cfg, params, t, 7, lm.init_cache(cfg, B, S_MAX, dev))[0]
                for B, t in toks.items()}
        out1 = dec(toks[1], 7)
        for _ in range(2):
            for B, t in toks.items():
                assert torch.equal(dec(t, 7), want[B])
        assert torch.equal(out1, want[1])  # B = 2's replays left B = 1's output alone
    assert sorted(dec.steps) == [1, 2]
    assert dec.steps[1].graph is not dec.steps[2].graph


# ---------------------------------------------------------------------------
# the compiled train step (launch.steps.CompiledTrainStep)
# ---------------------------------------------------------------------------

TRAIN_CAPTURE_STEPS = 4


def _train_case(dev, arch, compute=torch.float32):
    from repro_torch.configs import get_smoke
    from repro_torch.models import lm
    from repro_torch.train import data, optimizer

    cfg = dataclasses.replace(get_smoke(arch), compute_dtype=compute)
    ocfg = optimizer.OptConfig(lr=1e-3, warmup_steps=2, total_steps=5)
    it = iter(data.PackedBatcher(data.SyntheticSource(cfg.vocab, seed=0), 2, 16))
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in next(it).items()}
               for _ in range(TRAIN_CAPTURE_STEPS)]
    return cfg, ocfg, lm.init_params(cfg, 0, dev), batches


def _fresh(p, ocfg):
    from repro_torch.models import blocks
    from repro_torch.train import optimizer

    q = blocks.tree_map(torch.clone, p)
    return q, optimizer.init_opt_state(ocfg, q)


def _train_run(step, p, st, batches):
    from repro_torch.train import optimizer

    ms = []
    for b in batches:
        p, st, m = step(p, st, b)
        ms.append({k: v.clone() for k, v in m.items()})
    return ms, [x.clone() for x in optimizer.sorted_leaves((p, st))]


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "olmoe-1b-7b", "recurrentgemma-2b",
                                  "mamba2-130m", "gemma2-9b"])
def test_captured_train_step_equals_eager(dev, arch, compute):
    """4 steps at smoke width: the compiled step (a warm-up step, then 3
    replays) against eager ``make_train_step`` from the same parameters
    and batches: bit for bit where two eager runs are; where the card's
    atomics make two eager runs differ, within the CPU tests' float32
    bounds (loss 1e-6, grad norm 1e-5, parameters 0.25 lr)."""
    from repro_torch.launch import steps

    cfg, ocfg, p, batches = _train_case(dev, arch, getattr(torch, compute))
    step = steps.CompiledTrainStep(cfg, ocfg)
    got, got_state = _train_run(step, *_fresh(p, ocfg), batches)
    eager = steps.make_train_step(cfg, ocfg)
    (want, want_state), (again, again_state) = (_train_run(eager, *_fresh(p, ocfg), batches)
                                                for _ in range(2))
    assert step.builds == 1 and step.graph is not None
    if all(torch.equal(a[k], b[k]) for a, b in zip(want, again) for k in a) and all(
            torch.equal(a, b) for a, b in zip(want_state, again_state)):
        assert all(torch.equal(g[k], w[k]) for g, w in zip(got, want) for k in g)
        assert all(torch.equal(g, w) for g, w in zip(got_state, want_state, strict=True))
        return
    for g, w in zip(got, want):
        assert float(g["lr"]) == float(w["lr"])
        assert int(g["moe_dropped_slots"]) == int(w["moe_dropped_slots"])
        assert abs(float(g["loss"]) - float(w["loss"])) <= 1e-6 * abs(float(w["loss"]))
        assert abs(float(g["grad_norm"]) - float(w["grad_norm"])) <= 1e-5 * float(w["grad_norm"])
    for g, w in zip(got_state, want_state, strict=True):
        assert float((g.float() - w.float()).abs().max()) <= 0.25 * ocfg.lr


def test_train_step_graph_holds_the_step_and_no_host_copy(dev):
    """The captured step's graph: kernel nodes (the forward, the backward
    that autograd's device thread queued, AdamW), none of them hand-written,
    no memcpy node touching host memory; a replay allocates nothing outside
    the graph's pool."""
    from repro_torch.kernel_bench import graph_census, tick_entries
    from repro_torch.launch import steps

    cfg, ocfg, p, batches = _train_case(dev, "qwen3-1.7b", torch.bfloat16)
    step = steps.CompiledTrainStep(cfg, ocfg)
    p, st = _fresh(p, ocfg)
    p, st, _ = step(p, st, batches[0])
    census = graph_census(step.graph)
    assert census["kernel"] > 0 and census["host_memcpy"] == 0, census
    assert tick_entries(census["names"], lockstep=False) == {}
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    for b in batches[1:]:
        p, st, m = step(p, st, b)
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated(dev) == before and np.isfinite(float(m["loss"]))


def test_a_restored_state_makes_a_new_capture(dev):
    """Two steps (warm-up, replay), then another set of tensors holding
    the same values (a restore): a new build and graph, whose steps equal
    the first graph's run from those values."""
    from repro_torch.launch import steps
    from repro_torch.train import optimizer

    cfg, ocfg, p, batches = _train_case(dev, "qwen3-1.7b")
    step = steps.CompiledTrainStep(cfg, ocfg)
    p0, s0 = _fresh(p, ocfg)
    want, _ = _train_run(steps.CompiledTrainStep(cfg, ocfg), *_fresh(p, ocfg), batches)
    q, qs, _ = step(p0, s0, batches[0])
    q, qs, _ = step(q, qs, batches[1])
    first = step.graph
    restored = [x.clone() for x in optimizer.sorted_leaves((q, qs))]
    r, rs = _fresh(p, ocfg)
    for dst, src in zip(optimizer.sorted_leaves((r, rs)), restored, strict=True):
        dst.copy_(src)
    for b, w in zip(batches[2:], want[2:]):
        r, rs, m = step(r, rs, b)
        assert torch.equal(m["loss"], w["loss"]) or \
            abs(float(m["loss"]) - float(w["loss"])) <= 1e-6 * abs(float(w["loss"]))
    assert step.builds == 2 and step.graph is not first and step.graph is not None


def test_captured_mesh_step_equals_eager(dev, nccl1):
    """The step over DTensors on a (1, 1) mesh of the one-rank NCCL group,
    captured (DTensor's dispatch and its one-rank collectives in the
    graph), against the eager step over the same DTensors."""
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import regions
    from repro_torch.parallel import sharding
    from repro_torch.train import optimizer

    mesh = make_mesh((1, 1), ("data", "model"), "cuda")
    cfg, ocfg, p, batches = _train_case(dev, "qwen3-1.7b")
    specs = sharding.tree_param_specs(mesh, p)

    def placed():
        q, s = _fresh(p, ocfg)
        d = lambda tree, sp: sharding.distribute(mesh, tree, sp)  # noqa: E731
        return d(q, specs), optimizer.AdamState(step=d(s.step, ()), mu=d(s.mu, specs),
                                                nu=d(s.nu, specs), err=None)

    tb = [sharding.distribute(mesh, b, sharding.tokens_spec(mesh)) for b in batches]
    step = steps.CompiledTrainStep(cfg, ocfg)
    got, _ = _train_run(step, *placed(), tb)
    want, _ = _train_run(steps.make_train_step(cfg, ocfg), *placed(), tb)
    assert step.graph is not None
    for g, w in zip(got, want):
        gl, wl = float(regions.full(g["loss"])), float(regions.full(w["loss"]))
        assert gl == wl or abs(gl - wl) <= 1e-6 * abs(wl)
