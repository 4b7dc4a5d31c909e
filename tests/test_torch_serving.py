"""The port's serving path (``repro_torch.sched`` and
``repro_torch.launch.serve``) against the JAX package's, on the CPU.

The control plane is host-side numpy in both packages and is held exactly:
under ``benchmarks/bench_serving.py``'s drive, every counter and every
request's final fields are equal. The serve driver at ``--smoke``, fed the
reference's prompts and parameters, is held to a replica of the
reference's loop (``_torch_parity.jax_serve``):

  * its scheduler stats exactly: they depend on the numpy generator only;
  * every emitted token, with float32 and with the config's bfloat16
    compute (the model rounds as the reference's XLA program does,
    ``test_torch_models.py``; before that repair 1 of 24 requests parted
    at a reference top-2 margin of 0.0059, and the bfloat16 bound here was
    that margin, up to 2**-5).
"""

from __future__ import annotations

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import jax_params, jax_serve, port_arch, serving_drive

from repro.configs import get_smoke as jget_smoke
from repro.sched import paging as jpaging
from repro.sched import serving as jserving
from repro_torch.launch import serve as tserve
from repro_torch.models import lm as tlm
from repro_torch.sched import paging as tpaging
from repro_torch.sched import serving as tserving



def _serve_cfg(mod, airlock, pages):
    return mod.ServeConfig(pages_per_replica=pages, max_slots=8, airlock=airlock,
                           high_watermark=0.7, safe_watermark=0.5, t_susp=4, t_surv=16)


def _fields(req) -> dict:
    d = dataclasses.asdict(req)
    d["page_idx"] = None if req.page_idx is None else np.asarray(req.page_idx).tolist()
    return d


@pytest.mark.parametrize("airlock", [False, True])
@pytest.mark.parametrize("pages", [128, 32], ids=["bench", "pressure"])
def test_scheduler_equals_the_reference_under_the_bench_drive(airlock, pages):
    """4 replicas, 400 ticks at 1.2 arrivals a tick: ``bench_serving.run``'s
    settings (128 pages a replica), where the pools never pass the
    watermark, and 32 pages a replica, where the Airlock ladder suspends,
    resumes in place and reclaims. (Its ``migrated`` stays 0 in both
    packages: a migrating request re-enters the queue, and arbitration makes
    it ``reserved`` again, so its landing counts as ``started``.) Airlock
    off and on: stats, every request's final fields, the replicas' queues,
    slots and page bitmaps."""
    want = serving_drive(
        jserving.LaminarServingScheduler(_serve_cfg(jserving, airlock, pages), 4, seed=0),
        400, 1.2, np.random.default_rng(0))
    got = serving_drive(
        tserving.LaminarServingScheduler(_serve_cfg(tserving, airlock, pages), 4, seed=0),
        400, 1.2, np.random.default_rng(0))
    assert got.stats == want.stats
    assert want.stats["arrived"] > 400 and want.stats["completed"] > 0
    if airlock and pages == 32:  # the ladder ran
        assert min(want.stats[k] for k in ("suspended", "resumed_insitu", "reclaimed")) > 0
    assert got.requests.keys() == want.requests.keys()
    for rid, req in want.requests.items():
        assert _fields(got.requests[rid]) == _fields(req), rid
    for rw, rg in zip(want.replicas, got.replicas):
        assert rg.queue == rw.queue and rg.slots == rw.slots
        np.testing.assert_array_equal(rg.pages.free, rw.pages.free)
    assert got.t == want.t


def test_page_allocator_matches_the_reference():
    a, b = jpaging.PageAllocator(40), tpaging.PageAllocator(40)
    rng = np.random.default_rng(3)
    held = []
    for _ in range(200):
        if held and rng.uniform() < 0.4:
            i = int(rng.integers(len(held)))
            pa, pb = held.pop(i)
            a.release(pa)
            b.release(pb)
        else:
            n = int(rng.integers(1, 12))
            pa, pb = a.alloc(n), b.alloc(n)
            assert (pa is None) == (pb is None)
            if pa is not None:
                np.testing.assert_array_equal(pa, pb)
                held.append((pa, pb))
        assert a.free_pages == b.free_pages and a.utilization() == b.utilization()


def _first_difference(want, got):
    return next((i for i, (x, y) in enumerate(zip(want, got)) if x != y), None)


@functools.lru_cache(maxsize=None)
def _reference(dtype):
    """qwen3-1.7b's smoke config with ``dtype`` compute, the reference's
    parameters for seed 0 (both packages' trees) and the replica's run."""
    jc = dataclasses.replace(jget_smoke("qwen3-1.7b"), compute_dtype=jnp.dtype(dtype))
    jp, tp = jax_params(jc, seed=0)
    return jc, tp, jax_serve(jc, jp)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_serve_driver_equals_the_reference_loop(dtype):
    """``serve`` at qwen3-1.7b's smoke width (24 requests, 2 replicas, 120
    ticks, seed 0), fed the reference's prompts and parameters."""
    jc, tp, (sched, want, prompts, margins) = _reference(dtype)
    stats, got, reqs = tserve.serve(port_arch(jc), tp, prompts=lambda rid, n: prompts[rid],
                                    device="cpu")
    assert stats == sched.stats
    assert stats["completed"] == 24
    assert {r: q.state for r, q in reqs.items()} == {r: q.state for r, q in sched.requests.items()}
    assert got.keys() == want.keys()
    for rid in want:
        assert len(got[rid]) == len(want[rid]), rid
        i = _first_difference(want[rid], got[rid])
        assert i is None, (rid, want[rid], got[rid], margins[rid][i] if i is not None else None)


def test_serve_stats_do_not_depend_on_the_model():
    """The scheduler's stats come from the numpy generator alone: the port's
    own random parameters and prompts give the reference loop's stats (what
    ``chip_smoke.py`` phase 8 uses to hold a full-width run on the card to a
    smoke run on the CPU)."""
    jc, _, (sched, _, _, _) = _reference("bfloat16")
    cfg = port_arch(jc)
    stats, emitted, _ = tserve.serve(cfg, tlm.init_params(cfg, 5, "cpu"), device="cpu")
    assert stats == sched.stats
    assert sum(len(v) for v in emitted.values()) == sum(
        r.generated for r in sched.requests.values())


def test_serve_raises_without_cuda_unless_asked_for_the_cpu(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default runs")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserve.main(["--smoke"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserve.serve(port_arch(jget_smoke("qwen3-1.7b")), {}, requests=1)
    tserve.main(["--smoke", "--device", "cpu", "--requests", "4", "--ticks", "30"])
    out = capsys.readouterr().out
    assert "arch=qwen3-1.7b replicas=2 arrived=4" in out and "completed=4" in out
