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
    """A call is one launch of one cluster (torch.profiler sees one kernel)."""
    from torch.profiler import ProfilerActivity, profile

    args = [a.to(dev) for a in _survival_args(3, 65536, 5000)]
    kw = dict(airlock=True, residual=0.3, watermark=0.9, safe=0.8, t_susp=80, t_surv=240)
    survival_scan.survival_scan(*args, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        survival_scan.survival_scan(*args, **kw)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = [n for n in names if "survival" in n]
    assert len(kernels) == 1, names


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


def test_flat_tick_launches_bitmap_fit_rounds_once(dev):
    """The flat tick runs its arbitration rounds as one bitmap_fit_rounds
    launch and never the one-round bitmap_fit."""
    cfg = dataclasses.replace(SMALL_EXP5, airlock=True)
    eng = LaminarEngine(cfg, device=dev)
    s, lam = eng.init(0)
    draws = eng.draws(lam, s.zstart.shape[0], 0)
    counters = (bitmap_fit.bitmap_fit_rounds, bitmap_fit.bitmap_fit,
                bitmap_fit.bitmap_fit_blocked, bitmap_fit.bitmap_fit_rounds_blocked)
    before = [c.launches for c in counters]
    eng.simulate(s, draws, 30)
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == [30, 0, 0, 0]


def test_sharded_tick_launches_bitmap_fit_rounds_blocked_once(dev, tmp_path):
    """The zone-sharded tick (one NCCL rank) runs its arbitration rounds as
    one bitmap_fit_rounds_blocked launch, never a one-round entry, and
    equals the flat engine on the card."""
    import torch.distributed as dist

    from repro_torch.parallel.engine_mesh import ZoneShardedEngine

    cfg = dataclasses.replace(SMALL_EXP5, airlock=True)
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        mesh = ZoneShardedEngine(cfg, device=dev)
        counters = (bitmap_fit.bitmap_fit_rounds_blocked, bitmap_fit.bitmap_fit_rounds,
                    bitmap_fit.bitmap_fit_blocked, bitmap_fit.bitmap_fit)
        before = [c.launches for c in counters]
        got = mesh.run(seed=0, num_ticks=30)
        assert [c.launches - b for c, b in zip(counters, before)] == [30, 0, 0, 0]
    finally:
        dist.destroy_process_group()
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
