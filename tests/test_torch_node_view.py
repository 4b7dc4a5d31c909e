"""The true node view in one launch (``hotpath.node_view``, ``node_view``).

Nets, on the CPU:

  * the CPU route equals the chain it replaced (``bitmap.unpack_bits``,
    then the sum and ``bitmap.max_run``) and a run count written out in
    Python, at the corners of ``repro_torch.kernel_bench.view_edge_cases``
    (every atom free, none free, a run across atoms 31 and 32, runs that
    end at the top atom, alternating atoms, random words, bits past 48 and
    80 atoms) and on random words;
  * ``zhaf.build_view`` equals the JAX package's ``build_view`` at a small
    config, view for view;
  * under ``torch.func.vmap`` (the lockstep tick) the entry equals its
    calls seed by seed;

and on the card (skipped without one): the kernel equals the plain version
bit for bit at the corners and at Exp5's and Exp7's shapes, eager and in a
captured graph, and the lockstep tick launches it once a tick for all
seeds. No JAX is imported at the top: the card's machine has none.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import LaminarConfig, LaminarEngine, MemoryConfig, bitmap, hotpath, zhaf
from repro_torch.kernel_bench import view_edge_cases, view_inputs
from repro_torch.kernels.node_view import node_view, node_view_ref
from repro_torch.kernels.node_view import plan as view_plan
from repro_torch.kernels.node_view.ops import node_view_op

CORNERS = view_edge_cases()
SMALL = LaminarConfig(num_nodes=64, zone_size=32, probe_capacity=1024, max_arrivals_per_tick=64,
                      horizon_ms=40.0, rho=0.8, airlock=True, memory=MemoryConfig(enabled=True))


def _chain(words, atoms):
    bits = bitmap.unpack_bits(words, atoms)
    return torch.sum(bits, dim=-1).to(torch.float32), bitmap.max_run(bits).to(torch.float32)


def _python_counts(words, atoms):
    """Free atoms and longest free run of each row, atom by atom."""
    w = words.numpy().view(np.uint32)
    s, run = [], []
    for row in w:
        free = [(int(row[a // 32]) >> (a % 32)) & 1 for a in range(atoms)]
        best = cur = 0
        for f in free:
            cur = cur + 1 if f else 0
            best = max(best, cur)
        s.append(sum(free))
        run.append(best)
    return torch.tensor(s, dtype=torch.float32), torch.tensor(run, dtype=torch.float32)


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.float32 and g.shape == w.shape
        assert torch.equal(g, w)


@pytest.mark.parametrize("name", sorted(CORNERS))
def test_plain_route_equals_the_chain_at_corners(name):
    (words,), kw = CORNERS[name]
    got = node_view(words, **kw)
    _equal(got, _chain(words, kw["atoms"]))
    _equal(got, _python_counts(words, kw["atoms"]))
    _equal(node_view_ref(words, **kw), got)


def test_corners_hold_what_their_names_say():
    s, run = node_view(*CORNERS["across_31_32"][0], **CORNERS["across_31_32"][1])
    assert torch.equal(s, run) and int(run.min()) >= 2  # one run a row, across atom 31/32
    s, run = node_view(*CORNERS["to_the_top"][0], **CORNERS["to_the_top"][1])
    assert torch.equal(run[:33], 64 - torch.arange(33, dtype=torch.float32))
    s, run = node_view(*CORNERS["alternating"][0], **CORNERS["alternating"][1])
    assert s.tolist() == [32.0, 32.0] and run.tolist() == [1.0, 1.0]
    (words,), kw = CORNERS["garbage_past_48"]
    assert kw["atoms"] == 48 and int((words[:, 1] >> 16).ne(0).sum()) > 0


@pytest.mark.parametrize("W,atoms", [(1, 32), (2, 64), (2, 61), (3, 80)])
def test_plain_route_equals_the_chain_on_random_words(W, atoms):
    (words,), kw = view_inputs(400, W, atoms, seed=W * atoms)
    got = node_view(words, **kw)
    _equal(got, _chain(words, atoms))
    _equal(got, _python_counts(words, atoms))
    assert int((got[1] == atoms).sum()) > 0 and int((got[1] == 0).sum()) > 0


def test_build_view_equals_jax_build_view():
    """At a small config, on random words and probes queued on random
    nodes (so Heat is not zero), the fields ``build_view`` reads of a state:
    every field of the view equals the JAX package's, exactly; the port's
    view holds no bit plane."""
    from types import SimpleNamespace

    import jax
    import jax.numpy as jnp

    from repro.core import LaminarConfig as JaxConfig
    from repro.core import MemoryConfig as JaxMemoryConfig
    from repro.core import zhaf as jax_zhaf
    from repro_torch.core.state import QUEUED

    jc = JaxConfig(num_nodes=64, zone_size=32, probe_capacity=1024, max_arrivals_per_tick=64,
                   horizon_ms=40.0, rho=0.8, airlock=True, memory=JaxMemoryConfig(enabled=True))
    rng = np.random.default_rng(3)
    (words,), _ = view_inputs(64, 2, seed=3)
    st = np.where(rng.uniform(size=1024) < 0.3, QUEUED, 0).astype(np.int32)
    node = rng.integers(0, 64, 1024).astype(np.int32)
    want = jax.jit(lambda free, st, node: jax_zhaf.build_view(jc, SimpleNamespace(
        free=free, st=st, node=node)))(jnp.asarray(words.numpy().view(np.uint32)),
                                       jnp.asarray(st), jnp.asarray(node))
    got = zhaf.build_view(SMALL, SimpleNamespace(
        free=words, st=torch.from_numpy(st), node=torch.from_numpy(node)))
    assert got.bits is None
    for field in ("s_true", "h_true", "run_true"):
        np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                                      err_msg=field)
    assert float(got.h_true.sum()) > 0 and float(got.run_true.max()) == 64.0


def test_entry_under_vmap_equals_seed_by_seed():
    """The custom op under ``torch.func.vmap`` (the lockstep tick) and the
    wrapper given the seed axis equal the entry called seed by seed; the
    plan of the words with a seed axis is the same entry's launch with
    ``seeds`` set."""
    words = torch.stack([view_inputs(37, 2, 61, seed=b)[0][0] for b in range(3)])
    want = [node_view(words[b], atoms=61) for b in range(3)]
    want = tuple(torch.stack(o) for o in zip(*want))
    _equal(torch.func.vmap(lambda w: hotpath.node_view(dataclasses.replace(
        SMALL, atoms_per_node=61), w))(words), want)
    _equal(torch.func.vmap(lambda w: node_view_op(w, atoms=61), in_dims=1)(
        words.movedim(0, 1)), want)
    _equal(node_view(words, atoms=61), want)
    one, many = view_plan.for_call(words[0], atoms=61), view_plan.for_call(words, atoms=61)
    assert (one.entry, many.entry, one.seeds, many.seeds) == ("node_view", "node_view", 0, 3)
    assert many.launches == tuple(dataclasses.replace(L, seeds=3) for L in one.launches)
    with pytest.raises(ValueError, match="65 atoms in 2 words"):
        view_plan.plan(37, 2, 65)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA (an NVIDIA GPU)")
    return torch.device("cuda")


SHAPES = {"Exp5": (5000, 2), "Exp7": (65536, 2)}


def _cases():
    cases = dict(CORNERS)
    for label, (N, W) in SHAPES.items():
        cases[label] = view_inputs(N, W, seed=N)
        cases[f"{label}, 61 atoms"] = view_inputs(N, W, 61, seed=N + 1)
    return cases


@pytest.mark.cuda
def test_kernel_equals_plain_eager_and_captured(dev):
    """Every corner and Exp5's and Exp7's shapes: one launch, bit for bit
    the plain version's outputs; in a captured graph one kernel node whose
    replays give the same outputs."""
    from repro_torch.kernel_bench import graph_nodes

    for name, ((words,), kw) in _cases().items():
        want = node_view_ref(words, **kw)
        d = words.to(dev)
        n0 = node_view.launches
        got = node_view(d, **kw)
        assert node_view.launches == n0 + 1
        _equal(tuple(g.cpu() for g in got), want)
        if name in SHAPES:
            names = []
            assert graph_nodes(lambda: node_view(d, **kw), names) == {
                "kernel": 1, "memcpy": 0, "memset": 0, "other": 0}
            assert names and all("node_view_kernel" in n for n in names)
            out = node_view_op(d, **kw)
            g = torch.cuda.CUDAGraph()
            s = torch.cuda.Stream()
            s.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(s):
                node_view_op(d, **kw)
            torch.cuda.current_stream().wait_stream(s)
            with torch.cuda.graph(g):
                out = node_view_op(d, **kw)
            for _ in range(3):
                g.replay()
                torch.cuda.synchronize()
                _equal(tuple(o.cpu() for o in out), want)


@pytest.mark.cuda
def test_batched_kernel_equals_plain_seed_by_seed(dev):
    words = torch.stack([view_inputs(5000, 2, seed=b)[0][0] for b in range(4)])
    want = node_view(words, atoms=64)
    n0 = node_view.launches
    got = node_view(words.to(dev), atoms=64)
    assert node_view.launches == n0 + 1
    _equal(tuple(g.cpu() for g in got), want)


@pytest.mark.cuda
def test_lockstep_tick_launches_the_view_once_for_all_seeds(dev):
    """B = 3 seeds in lockstep: the captured tick's graph holds one
    node_view kernel (its grid with the seed axis), replayed once a tick;
    the eager lockstep tick counts one launch a tick, not one a seed; the
    flat tick one node_view a tick."""
    from repro_torch.core.draws import BatchDraws
    from repro_torch.core.engine import make_step
    from repro_torch.core.scan import watching
    from repro_torch.kernel_bench import graph_census, tick_entries

    eng = LaminarEngine(SMALL, device=dev)
    sb, lam = eng.init_batch([0, 1, 2])
    draws = BatchDraws([eng.draws(lam, sb.zstart.shape[1], sd) for sd in (0, 1, 2)])
    with watching() as runs:
        eng.simulate_batch(sb, draws, 5)
    ((compiled, replays),) = runs
    assert replays == 5
    assert tick_entries(graph_census(compiled.graph)["names"])["node_view"] == 1
    step = torch.func.vmap(make_step(SMALL), in_dims=(0, BatchDraws.in_dims(draws.tick(0))))
    n0 = node_view.launches
    for t in range(4):
        sb, _ = step(sb, draws.tick(t))
    torch.cuda.synchronize()
    assert node_view.launches - n0 == 4
    s, lam = eng.init(0)
    with watching() as runs:
        eng.simulate(s, eng.draws(lam, s.zstart.shape[0], 0), 5)
    ((compiled, _),) = runs
    assert tick_entries(graph_census(compiled.graph)["names"])["node_view"] == 1
