"""Shared helpers for the differential tests of the PyTorch port.

The JAX package (``repro``) is the reference. These helpers carry values
between the two packages as numpy arrays:

  * :func:`port_config` — a ``repro`` config as the port's config;
  * :func:`jax_state_to_numpy` — a JAX ``SimState`` as the numpy dict that
    ``repro_torch.core.state.state_from_numpy`` takes;
  * :class:`JaxTape` — replays the JAX engine's key schedule (the scenario's
    9-way split, arrival schedule and dispatch headroom included) and records
    every per-tick random value, after its distribution, as the port's
    ``Draws``, so both engines see the same randomness;
  * :func:`jax_reference_run`, :func:`jax_tape`, :func:`check_run_matches_jax`
    — a live JAX run, its tape, and the port's run held to it;
  * :func:`assert_outputs_equal` / :func:`first_divergence` — compare two
    ``summarize()`` dicts.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import config as jcfg
from repro.workloads import schedule as jsched
from repro_torch.core import config as tcfg
from repro_torch.core.draws import ArrayDraws, Draws, max_dispatch
from repro_torch.workloads import scenario as tscen

# The parity tests run small tensors, where intra-op threads only add
# overhead and oversubscribe the CPU under parallel test workers.
torch.set_num_threads(1)


def port_config(cfg: jcfg.LaminarConfig) -> tcfg.LaminarConfig:
    """The port's ``LaminarConfig`` with every field of ``cfg``."""
    d = dataclasses.asdict(cfg)
    d.pop("use_pallas")
    sc = d.pop("scenario")
    return tcfg.LaminarConfig(
        workload=tcfg.WorkloadConfig(**d.pop("workload")),
        memory=tcfg.MemoryConfig(**d.pop("memory")),
        scenario=tscen.ScenarioConfig(
            name=sc["name"],
            schedule=tscen.ScheduleConfig(**sc["schedule"]),
            disruption=tscen.DisruptionConfig(**sc["disruption"]),
        ),
        **d,
    )


def jax_state_to_numpy(s) -> dict:
    """A JAX ``SimState`` as numpy arrays (JAX dtypes; metrics nested)."""
    out = {f: np.asarray(getattr(s, f)) for f in s._fields if f != "metrics"}
    out["metrics"] = {f: np.asarray(getattr(s.metrics, f)) for f in s.metrics._fields}
    return out


def _split_ways(cfg: jcfg.LaminarConfig) -> int:
    """``engine.make_step``'s per-tick key split: 9 ways with disruption."""
    return 9 if cfg.scenario.disruption.enabled else 8


def _draws_from_keys(cfg: jcfg.LaminarConfig, lam, num_zones: int, ks) -> dict:
    """Every random value of one tick, drawn exactly as ``repro.core`` draws
    it from the tick's subkeys ``ks`` (``engine.make_step``'s split); ``lam``
    is the tick's Poisson intensity."""
    N, P = cfg.num_nodes, cfg.probe_capacity
    n_max, K = cfg.max_arrivals_per_tick, cfg.candidate_k
    D = max_dispatch(port_config(cfg))
    w = cfg.workload
    r = jax.random

    def choice(key, values, probs):
        p = jnp.asarray(probs, jnp.float32)
        idx = r.choice(key, len(values), shape=(n_max,), p=p / p.sum())
        return jnp.asarray(values, jnp.float32)[idx]

    out = {}
    # airlock.memory_dynamics (ks[1])
    k_n, k_b, k_bs = r.split(ks[1], 3)
    out["mem_noise"] = r.normal(k_n, (N,))
    out["burst_u"] = r.uniform(k_b, (N,))
    out["burst_v"] = r.uniform(k_bs, (N,))
    # zhaf.report (ks[0])
    k_loss, k_jit = r.split(ks[0])
    out["rep_loss"] = r.uniform(k_loss, (N,))
    out["rep_jit"] = r.normal(k_jit, (N,))
    # engine._inject_arrivals (ks[2]) -> workload.sample_arrivals
    k_batch, k_oc, k_ocv = r.split(ks[2], 3)
    a = r.split(k_batch, 11)
    out["arr_n"] = r.poisson(a[0], lam).astype(jnp.int32)
    out["arr_l"] = r.uniform(a[1], (n_max,))
    out["arr_squat"] = r.uniform(a[2], (n_max,))
    tp = jnp.asarray(w.tier_probs, jnp.float32)
    out["arr_tier"] = r.choice(
        a[10], len(w.tier_probs), shape=(n_max,), p=tp / tp.sum()
    ).astype(jnp.int32)
    out["arr_mass_f"] = choice(a[3], w.f_masses, w.f_mass_probs)
    out["arr_mass_l"] = choice(a[4], w.l_masses, w.l_mass_probs)
    out["arr_pri_f"] = choice(a[5], w.f_priorities, w.f_priority_probs)
    out["arr_pri_l"] = choice(a[6], w.l_priorities, w.l_priority_probs)
    out["arr_svc_exp"] = r.exponential(a[7], (n_max,))
    out["arr_svc_norm"] = r.normal(a[8], (n_max,))
    out["arr_pull_exp"] = r.exponential(a[9], (n_max,))
    out["oc_u"] = r.uniform(k_oc, (n_max,))
    out["oc_v"] = r.uniform(k_ocv, (n_max,))
    # da.move (ks[3])
    out["move_loss"] = r.uniform(ks[3], (P,))
    # teg.dispatch (ks[4])
    k_zone, k_node = r.split(ks[4])
    out["gumbel"] = r.gumbel(k_zone, (D, num_zones))
    out["launch_u"] = r.uniform(k_node, (D,))
    # da.address (ks[5])
    k_cand, k_noise = r.split(ks[5])
    out["cand_u"] = r.uniform(k_cand, (P, K - 1))
    out["addr_eps"] = r.normal(k_noise, (P, K))
    if cfg.scenario.disruption.enabled:
        # workloads.disruption_step (ks[7])
        k_evt, k_site = r.split(ks[7])
        out["dis_u"] = r.uniform(k_evt, ())
        out["dis_start"] = r.randint(k_site, (), 0, N)
    return out


def draws_from_key(cfg, lam: float, num_zones: int, key) -> Draws:
    """The ``Draws`` of one tick whose state carries ``key``."""
    _, *ks = jax.random.split(key, _split_ways(cfg))
    d = _draws_from_keys(cfg, lam, num_zones, ks)
    return Draws(**{k: torch.from_numpy(np.array(v)) for k, v in d.items()})


class JaxTape(ArrayDraws):
    """Replays the JAX engine's key schedule from ``PRNGKey(seed)`` (and the
    arrival schedule from ``schedule_key(seed)``) for ``num_ticks`` ticks of
    ``cfg.scenario``, in one jitted scan, and hands tick ``t``'s values as
    the port's ``Draws`` (CPU tensors). ``ArrayDraws(tape.arrays)`` carries
    the same values to processes without JAX."""

    def __init__(self, cfg: jcfg.LaminarConfig, lam: float, num_zones: int,
                 seed: int, num_ticks: int):
        sched = cfg.scenario.schedule
        sched_key = jsched.schedule_key(seed)

        def step(carry, _):
            key, t = carry
            key, *ks = jax.random.split(key, _split_ways(cfg))
            if sched.kind == "stationary":
                lam_t = lam  # the engine's exact pre-scenario arrival stream
            else:
                lam_t = jsched.rate_per_tick(sched, lam, t, sched_key, cfg.dt_ms)
            return (key, t + 1), _draws_from_keys(cfg, lam_t, num_zones, ks)

        _, tape = jax.jit(
            lambda k: jax.lax.scan(step, (k, jnp.zeros((), jnp.int32)), None, length=num_ticks)
        )(jax.random.PRNGKey(seed))
        super().__init__({k: np.asarray(v) for k, v in tape.items()})


def jax_staged_tick(cfg: jcfg.LaminarConfig, s, lam: float):
    """One tick of ``repro.core.engine.make_step`` (stationary, no
    disruption), stage by stage, eagerly. Returns the tick's ``Draws`` and a
    list of ``(stage, state_in, output, extra)``: the JAX state each stage
    read, what it returned, and the other values it took."""
    from repro.core import airlock, arbiter, da, engine, hotpath, teg, zhaf

    draws = draws_from_key(cfg, lam, len(s.zstart), s.key)
    key, *ks = jax.random.split(s.key, _split_ways(cfg))
    s = s._replace(key=key)
    rec = []

    def stage(name, fn, *args, **extra):
        out = fn(cfg, s, *args)
        rec.append((name, s, out, extra))
        return out

    s = stage("memory_dynamics", airlock.memory_dynamics, ks[1])
    pressure, victim, resume, react, expire = stage(
        "survival_scan", lambda c, st: hotpath.survival_scan(c, st)
    )
    s = stage("runtime_control", airlock.runtime_control, victim, victim=victim)
    s, react_mask = stage(
        "airlock_transitions", airlock.airlock_transitions, resume, react, expire,
        resume=resume, react=react, expire=expire,
    )
    s = stage("completions", arbiter.completions)
    view = stage("build_view", zhaf.build_view)
    s = stage("report", zhaf.report, ks[0], view, view=view)
    s = stage("refresh", teg.refresh)
    s, arrival_mask = stage("inject_arrivals", engine._inject_arrivals, ks[2], lam)
    s, regen_mask = stage("move", da.move, ks[3])
    mask = arrival_mask | regen_mask | react_mask
    D = max_dispatch(port_config(cfg))
    s = stage("dispatch", teg.dispatch, ks[4], mask, D, mask=mask)
    s = stage("address", da.address, ks[5], view, view=view)
    throttled = (
        (pressure > cfg.memory.high_watermark)
        if cfg.airlock
        else jnp.zeros((cfg.num_nodes,), jnp.bool_)
    )
    bits = view.bits
    for r in range(cfg.arb_rounds):
        s, bits_out = stage(
            f"arbitrate{r}", arbiter.arbitrate, ks[6], throttled, bits,
            throttled=throttled, bits=bits,
        )
        bits = bits_out
    s = stage("pending_stage", arbiter.pending_stage)
    s = stage("timeouts", arbiter.timeouts)
    return draws, rec


def jax_reference_run(cfg: jcfg.LaminarConfig, seed: int = 0):
    """One run of the JAX engine: its ``summarize()`` dict, the per-tick
    intensity ``lam`` and the zone count (what a :class:`JaxTape` needs)."""
    from repro.core import LaminarEngine
    from repro.core.engine import summarize

    eng = LaminarEngine(cfg)
    s0, lam = eng.init(seed)
    final, ts = eng._runner(lam, cfg.num_ticks)(s0)
    out = summarize(cfg, final, np.asarray(ts))
    out["lambda_per_s"] = lam / cfg.dt_ms * 1e3
    return out, lam, len(s0.zstart)


@functools.lru_cache(maxsize=None)
def _cached_tape(cfg: jcfg.LaminarConfig, seed: int) -> JaxTape:
    from repro.core import LaminarEngine

    s0, lam = LaminarEngine(cfg).init(seed)
    return JaxTape(cfg, lam, len(s0.zstart), seed=seed, num_ticks=cfg.num_ticks)


def jax_tape(cfg: jcfg.LaminarConfig, seed: int = 0) -> JaxTape:
    """The ``JaxTape`` of a run of ``cfg`` (``cfg.num_ticks`` ticks), cached
    per process. Airlock changes neither the draws nor the arrival rate, so
    runs with Airlock off and on share one tape."""
    return _cached_tape(dataclasses.replace(cfg, airlock=False), seed)


def check_run_matches_jax(cfg: jcfg.LaminarConfig, seed: int = 0) -> dict:
    """The port's flat engine on the CPU, fed the JAX draws, equals the live
    JAX engine on every metric, ``lat_hist`` and the timeseries."""
    from repro_torch.core.engine import LaminarEngine as TorchEngine

    want, _, _ = jax_reference_run(cfg, seed)
    got = TorchEngine(port_config(cfg), device="cpu").run(seed=seed, draws=jax_tape(cfg, seed))
    assert first_divergence(want, got) is None, first_divergence(want, got)
    assert_outputs_equal(want, got)
    return got


def first_divergence(a: dict, b: dict):
    """(tick, field) of the first timeseries difference, or None."""
    first = None
    for f in a["timeseries"]:
        diff = np.nonzero(np.asarray(a["timeseries"][f]) != np.asarray(b["timeseries"][f]))[0]
        if len(diff) and (first is None or diff[0] < first[0]):
            first = (int(diff[0]), f)
    return first


def assert_outputs_equal(a: dict, b: dict) -> None:
    """Every metric, the latency histogram and the timeseries equal."""
    assert set(a) == set(b), set(a) ^ set(b)
    for k in a:
        if k == "timeseries":
            for f in a[k]:
                np.testing.assert_array_equal(a[k][f], b[k][f], err_msg=f)
        elif k == "lat_hist":
            np.testing.assert_array_equal(a[k], b[k])
        elif isinstance(a[k], float) and np.isnan(a[k]):
            assert np.isnan(b[k]), k
        else:
            assert a[k] == b[k], (k, a[k], b[k])


# ---------------------------------------------------------------------------
# the composition utility_topk_address replaced
# ---------------------------------------------------------------------------


def address_composition(
    st, node, zone, timer, patience, migrating, mass, contig,
    cand_u, addr_eps, zstart, zcount, zone_id,
    rep_S, rep_H, rep_run, rep_t, dS, dH, s_true, h_true, run_true, t,
    *, gamma, sigma, stay_margin, eval_cost, bounce_cost, fastfail_floor, projection, tau,
    dt_ms, degrade_after_ms, degrade_halflife_ms,
):
    """The port's DA addressing step as it was before it became one kernel
    entry: ``core.zhaf.project`` of the candidates, the tile entry
    ``utility_topk_ref`` for the best candidate, the launchpad's score from
    ``core.utility.unified_utility``, and the selects of ``core.da.address``
    and ``_dissipate_st``, op for op, on the entry's arguments. Returns what
    ``utility_topk_address_ref`` returns."""
    from repro_torch.core.state import ADDRESSING, BOUNCING, EMPTY, QUEUED, SUSPENDED, count
    from repro_torch.core.utility import unified_utility
    from repro_torch.kernels.utility_topk import utility_topk_ref

    num_nodes = rep_S.shape[0]
    active = st == ADDRESSING

    zc = torch.clamp(zcount[zone], min=1).to(torch.float32)
    cand = zstart[zone][:, None] + torch.floor(cand_u * zc[:, None]).to(torch.int32)
    cand = torch.clamp(cand, 0, num_nodes - 1)
    here = torch.clamp(node, min=0)
    cand = torch.cat([here[:, None], cand], dim=1)

    # zhaf.project(cfg, s, cand)
    r_S, r_H, r_run = rep_S[cand], rep_H[cand], rep_run[cand]
    if projection:
        s_pred = torch.clamp(r_S + tau * dS[cand], min=0.0)
        h_pred = torch.clamp(r_H + tau * dH[cand], min=0.0)
    else:
        s_pred, h_pred = r_S, r_H
    age_ms = (t - rep_t[cand]).to(torch.float32) * dt_ms
    over = torch.clamp(age_ms - degrade_after_ms, min=0.0)
    factor = torch.exp2(-over / degrade_halflife_ms)
    s_eff, h_eff, run_eff = s_pred * factor, h_pred / torch.clamp(factor, min=1e-6), r_run * factor

    s_eff[:, 0] = s_true[here]
    h_eff[:, 0] = h_true[here]
    run_eff[:, 0] = run_true[here]
    mass_f = mass.to(torch.float32)[:, None]
    feas = torch.where(contig[:, None], run_eff >= mass_f, s_eff >= mass_f)

    eps = sigma * addr_eps
    best, best_score = utility_topk_ref(s_eff, h_eff, eps, feas, gamma)

    any_feas = torch.any(feas, dim=1)
    target = torch.gather(cand, 1, best[:, None].long())[:, 0]
    here_ok = feas[:, 0]
    here_score = torch.where(
        here_ok, unified_utility(s_eff[:, 0], h_eff[:, 0], gamma) + eps[:, 0], -torch.inf
    )
    prefer_here = here_ok & (best_score <= here_score + stay_margin)
    target = torch.where(prefer_here, here, target)

    stay = active & any_feas & (target == node)
    bounce = active & any_feas & (target != node)

    patience = torch.where(active, patience - eval_cost, patience)
    patience = torch.where(bounce, patience - bounce_cost, patience)

    new_st = torch.where(stay, QUEUED, st)
    new_st = torch.where(bounce, BOUNCING, new_st)
    new_node = torch.where(bounce, target, node)
    new_timer = torch.where(bounce, 1, timer)
    new_zone = torch.where(bounce, zone_id[target], zone)

    ff = active & (patience < fastfail_floor)
    # _dissipate_st(s._replace(st=new_st), ff)
    dissipated = torch.where(ff & migrating, SUSPENDED, new_st)
    dissipated = torch.where(ff & ~migrating, EMPTY, dissipated)
    new_st = torch.where(ff, dissipated, new_st)
    counts = torch.stack([count(active), count(bounce & ~ff), count(ff)])
    return new_st, new_node, new_zone, new_timer, patience, counts
