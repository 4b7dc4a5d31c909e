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
    (the comparison da.address makes for prefer_here)."""
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


@pytest.mark.parametrize("airlock", [False, True])
@pytest.mark.parametrize("P,N", [(1, 1), (777, 33), (2000, 7), (65536, 5000)])
def test_survival_scan_matches_plain(dev, airlock, P, N):
    kw = dict(
        airlock=airlock, residual=0.3, watermark=0.9 if airlock else 1.0,
        safe=0.8, t_susp=80, t_surv=240,
    )
    want, got = _both(survival_scan.survival_scan, _survival_args(P + N, P, N), kw, dev)
    for name, w, g in zip(("pressure", "victim", "resume", "react", "expire"), want, got):
        # pressure is summed in slot order on both sides: bit-equal
        torch.testing.assert_close(g, w, rtol=0, atol=0, msg=name)


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
