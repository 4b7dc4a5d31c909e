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
    ``summarize()`` dicts;
  * for the baselines: :func:`port_baseline_config`, :class:`JaxBaselineTape`
    (each model's key chain, drawn a tick at a time), :func:`jax_baseline_run`
    (a live JAX run built as its ``run`` builds it), :func:`port_baseline_run`,
    :func:`assert_summaries_equal`, :func:`state_differences` and
    :func:`check_baseline_run`;
  * for the LM serving path: :func:`port_arch` (a reference ``ArchConfig``
    as the port's), :func:`jax_params` (the reference's parameters, also
    as the port's tensors), :func:`jax_moe_picks` (each routing round's
    experts), :func:`jax_serve` (a replica of ``repro/launch/serve.py``'s
    loop) and :func:`serving_drive` (``bench_serving.py``'s drive).
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


def _arrival_draws(cfg: jcfg.LaminarConfig, lam, key) -> dict:
    """The ``arr_*`` values ``workload.sample_arrivals(cfg, key, lam)`` draws."""
    n_max = cfg.max_arrivals_per_tick
    w = cfg.workload
    r = jax.random

    def choice(k, values, probs):
        p = jnp.asarray(probs, jnp.float32)
        idx = r.choice(k, len(values), shape=(n_max,), p=p / p.sum())
        return jnp.asarray(values, jnp.float32)[idx]

    a = r.split(key, 11)
    tp = jnp.asarray(w.tier_probs, jnp.float32)
    return {
        "arr_n": r.poisson(a[0], lam).astype(jnp.int32),
        "arr_l": r.uniform(a[1], (n_max,)),
        "arr_squat": r.uniform(a[2], (n_max,)),
        "arr_tier": r.choice(
            a[10], len(w.tier_probs), shape=(n_max,), p=tp / tp.sum()
        ).astype(jnp.int32),
        "arr_mass_f": choice(a[3], w.f_masses, w.f_mass_probs),
        "arr_mass_l": choice(a[4], w.l_masses, w.l_mass_probs),
        "arr_pri_f": choice(a[5], w.f_priorities, w.f_priority_probs),
        "arr_pri_l": choice(a[6], w.l_priorities, w.l_priority_probs),
        "arr_svc_exp": r.exponential(a[7], (n_max,)),
        "arr_svc_norm": r.normal(a[8], (n_max,)),
        "arr_pull_exp": r.exponential(a[9], (n_max,)),
    }


def _disruption_draws(cfg: jcfg.LaminarConfig, key) -> dict:
    """The two values ``workloads.disruption_step`` draws from ``key``."""
    k_evt, k_site = jax.random.split(key)
    return {
        "dis_u": jax.random.uniform(k_evt, ()),
        "dis_start": jax.random.randint(k_site, (), 0, cfg.num_nodes),
    }


def _draws_from_keys(cfg: jcfg.LaminarConfig, lam, num_zones: int, ks) -> dict:
    """Every random value of one tick, drawn exactly as ``repro.core`` draws
    it from the tick's subkeys ``ks`` (``engine.make_step``'s split); ``lam``
    is the tick's Poisson intensity."""
    N, P = cfg.num_nodes, cfg.probe_capacity
    n_max, K = cfg.max_arrivals_per_tick, cfg.candidate_k
    D = max_dispatch(port_config(cfg))
    r = jax.random
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
    out.update(_arrival_draws(cfg, lam, k_batch))
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
        out.update(_disruption_draws(cfg, ks[7]))  # workloads.disruption_step
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


# ---------------------------------------------------------------------------
# the baseline models: tape, live JAX reference, port run
# ---------------------------------------------------------------------------

# the step's key split without disruption (one more way with it), whose
# first key is the next tick's: slurm_like.py:41, ray_like.py:54, flux_like.py:51
BASELINE_SPLIT = {"slurm": 3, "ray": 5, "flux": 4}


def port_baseline_config(bcfg: jcfg.BaselineConfig) -> tcfg.BaselineConfig:
    """The port's ``BaselineConfig`` with every field of ``bcfg``."""
    return tcfg.BaselineConfig(**dataclasses.asdict(bcfg))


def _baseline_draws_from_keys(name: str, cfg: jcfg.LaminarConfig, lam, capacity: int, ks) -> dict:
    """Every random value of one step of baseline ``name``, drawn exactly as
    ``repro.core.baselines`` draws it from the step's subkeys ``ks`` (the
    split less its first key); ``lam`` is the tick's Poisson intensity."""
    from repro_torch.core.baselines.draws import LEAF_GROUP, RAY_CANDIDATES, num_leaves

    N, C = cfg.num_nodes, capacity
    r = jax.random
    out = _arrival_draws(cfg, lam, ks[0])
    if name == "ray":
        out["local_node"] = r.randint(ks[1], (C,), 0, N)
        out["shard_u"] = r.uniform(ks[2], (C,))
        out["pick_node"] = r.randint(ks[3], (C, RAY_CANDIDATES), 0, N)
    elif name == "flux":
        out["leaf_gumbel"] = r.gumbel(ks[1], (C, num_leaves(port_config(cfg))))
        out["leaf_off"] = r.randint(ks[2], (C,), 0, LEAF_GROUP)
    if cfg.scenario.disruption.enabled:
        out.update(_disruption_draws(cfg, ks[-1]))
    return out


class JaxBaselineTape:
    """Replays baseline ``name``'s key chain from ``PRNGKey(seed)`` (and the
    arrival schedule from ``schedule_key(seed)``) for ``num_ticks`` ticks:
    one jitted scan records each tick's subkeys, and ``tick(t)`` draws that
    tick's values after their distribution as the port's ``BaselineDraws``
    (CPU tensors). Drawing a tick at a time keeps the flux model's (C,
    n_leaves) Gumbel table out of memory for all ticks at once."""

    def __init__(self, name: str, cfg: jcfg.LaminarConfig, lam: float, capacity: int,
                 seed: int, num_ticks: int):
        from repro_torch.core.baselines.draws import BaselineDraws

        self._cls = BaselineDraws
        self.model, self.capacity = name, capacity
        self.scenario = port_config(cfg).scenario
        ways = BASELINE_SPLIT[name] + int(cfg.scenario.disruption.enabled)
        sched = cfg.scenario.schedule
        sched_key = jsched.schedule_key(seed)

        def chain(key, _):
            keys = jax.random.split(key, ways)
            return keys[0], keys[1:]

        _, self.subkeys = jax.jit(
            lambda k: jax.lax.scan(chain, k, None, length=num_ticks)
        )(jax.random.PRNGKey(seed))

        def draw(ks, t):
            if sched.kind == "stationary":
                lam_t = lam  # the reference's exact pre-scenario arrival stream
            else:
                lam_t = jsched.rate_per_tick(sched, lam, t, sched_key, cfg.dt_ms)
            return _baseline_draws_from_keys(name, cfg, lam_t, capacity, ks)

        self._draw = jax.jit(draw)

    def tick(self, t: int):
        d = self._draw(self.subkeys[t], jnp.int32(t))
        return self._cls(**{k: torch.from_numpy(np.array(v)) for k, v in d.items()})


def jax_tree_to_numpy(x):
    """A JAX state (nested NamedTuples) as nested dicts of numpy arrays."""
    if hasattr(x, "_fields"):
        return {f: jax_tree_to_numpy(getattr(x, f)) for f in x._fields}
    return np.asarray(x)


@functools.lru_cache(maxsize=None)
def jax_baseline_run(name: str, cfg: jcfg.LaminarConfig, bcfg: jcfg.BaselineConfig,
                     seed: int, capacity: int, num_ticks: int):
    """A live run of the JAX baseline ``name``: its state built exactly as
    its ``run`` builds it, the same ``jax.jit(lax.scan(step, ...))``. Returns
    ``(summary, final state as numpy, (T, 3) per-tick series, lam)``, cached
    per process."""
    from repro.core import bitmap as jbitmap
    from repro.core.baselines import common as JC
    from repro.core.baselines import flux_like, ray_like, slurm_like

    mod = {"slurm": slurm_like, "ray": ray_like, "flux": flux_like}[name]
    free, lam = JC.init_cluster(cfg, seed)
    base = dict(
        tt=JC.TaskTable.empty(capacity, free.shape[1]),
        free=free,
        t=jnp.zeros((), jnp.int32),
        key=jax.random.PRNGKey(seed),
        scen=JC.scenario_init(cfg, seed, free),
        metrics=JC.BaseMetrics.zeros(),
    )
    zero = jnp.zeros((), jnp.float32)
    true_S = jnp.sum(jbitmap.unpack_bits(free, cfg.atoms_per_node), axis=-1).astype(jnp.float32)
    if name == "slurm":
        s = mod.SlurmState(carry=zero, **base)
    elif name == "ray":
        s = mod.RayState(stale_S=true_S, carry_hot=zero, carry_cold=zero, **base)
    else:
        n_leaves = max(1, cfg.num_nodes // 32)
        leaf_S = true_S[: n_leaves * 32].reshape(n_leaves, 32).sum(axis=-1)
        s = mod.FluxState(stale_leaf_S=leaf_S, carry=zero, **base)
    step = mod.make_step(cfg, bcfg, lam)
    final, ys = jax.jit(lambda s0: jax.lax.scan(step, s0, None, length=num_ticks))(s)
    out = JC.summarize_baseline(cfg, final.metrics, final.tt)
    out["lambda_per_s"] = lam / cfg.dt_ms * 1e3
    return out, jax_tree_to_numpy(final), np.asarray(ys), lam


def port_baseline_run(name: str, cfg: jcfg.LaminarConfig, bcfg: jcfg.BaselineConfig,
                      seed: int, capacity: int, num_ticks: int, draws, observe=None):
    """The port's baseline ``name`` on the CPU fed ``draws``: ``(summary,
    final state as numpy, (T, 3) per-tick series)``. ``observe(state)`` is
    called with the state each step leaves."""
    from repro_torch.core.baselines import common as TC
    from repro_torch.core.baselines import flux_like, ray_like, slurm_like

    mod = {"slurm": slurm_like, "ray": ray_like, "flux": flux_like}[name]
    pcfg = port_config(cfg)
    s, lam = mod.init(pcfg, seed, capacity, device="cpu")
    TC.check_draws(draws, name, pcfg, capacity)
    step = mod.make_step(pcfg, port_baseline_config(bcfg))
    if observe is not None:
        inner = step

        def step(s, d):
            s, y = inner(s, d)
            observe(s)
            return s, y

    final, ys = TC.simulate(step, s, draws, num_ticks)
    out = TC.summarize_baseline(pcfg, final.metrics, final.tt)
    out["lambda_per_s"] = lam / cfg.dt_ms * 1e3
    return out, TC.state_to_numpy(final), ys.numpy()


def assert_summaries_equal(a: dict, b: dict) -> None:
    """Two baseline summaries equal key for key (NaN equals NaN)."""
    assert set(a) == set(b), set(a) ^ set(b)
    for k in a:
        if isinstance(a[k], float) and np.isnan(a[k]):
            assert np.isnan(b[k]), k
        else:
            assert a[k] == b[k], (k, a[k], b[k])


def state_differences(want: dict, got: dict, prefix: str = "") -> list:
    """Fields of the port's state (nested numpy dicts) that differ from the
    reference's, bit for bit (floats by their bits); fields the port does
    not hold (the PRNG keys) are skipped."""
    diff = []
    for f, g in got.items():
        if isinstance(g, dict):
            diff += state_differences(want[f], g, f"{prefix}{f}.")
            continue
        w = np.asarray(want[f])
        if w.dtype != g.dtype or w.shape != g.shape or w.tobytes() != g.tobytes():
            diff.append(prefix + f)
    return diff


def check_baseline_run(name: str, cfg: jcfg.LaminarConfig, bcfg: jcfg.BaselineConfig,
                       capacity: int, observe=None) -> dict:
    """The port's baseline ``name`` on the CPU, fed ``JaxBaselineTape``,
    equals the live JAX run: the per-tick series, the final state bit for
    bit (task table, words, scenario state, every float carry) and the
    summary. Returns the port's summary."""
    want, wfin, wys, lam = jax_baseline_run(name, cfg, bcfg, 0, capacity, cfg.num_ticks)
    tape = JaxBaselineTape(name, cfg, lam, capacity, 0, cfg.num_ticks)
    got, gfin, gys = port_baseline_run(name, cfg, bcfg, 0, capacity, cfg.num_ticks, tape,
                                       observe)
    bad = np.nonzero((wys != gys).any(axis=-1))[0]
    assert len(bad) == 0, f"series differ first at tick {bad[0]}"
    diff = state_differences(wfin, gfin)
    assert not diff, diff
    assert_summaries_equal(want, got)
    return got



# ---------------------------------------------------------------------------
# the LM serving path: configs, parameters, the MoE routing, the serve loop
# ---------------------------------------------------------------------------

TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def port_arch(cfg):
    """A ``repro`` ``ArchConfig`` as the port's, field for field (the
    ``jnp`` dtypes as ``torch`` dtypes)."""
    from repro_torch.models import common as tcm

    d = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    for k in ("param_dtype", "compute_dtype"):
        d[k] = TORCH_DTYPE[jnp.dtype(d[k]).name]
    if cfg.moe is not None:
        d["moe"] = tcm.MoEConfig(**dataclasses.asdict(cfg.moe))
    if cfg.ssm is not None:
        d["ssm"] = tcm.SSMConfig(**dataclasses.asdict(cfg.ssm))
    return tcm.ArchConfig(**d)


def jax_params(cfg, seed: int = 0):
    """The reference's ``lm.init_params`` and the same values as the
    port's tensors on the CPU."""
    from repro.models import lm as jlm
    from repro_torch.models import bridge

    jp = jax.jit(functools.partial(jlm.init_params, cfg))(jax.random.PRNGKey(seed))
    return jp, bridge.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def jax_moe_picks(params, cfg, x):
    """The experts and kept flags of each routing round of the reference's
    ``moe.moe_ffn`` (its router prelude and ``_assign_round`` loop, line for
    line), as numpy (rounds, T) arrays."""
    from repro.models import moe as jmoe

    mc = cfg.moe
    T = x.shape[0] * x.shape[1]
    xt = x.reshape(T, -1)
    E = mc.num_experts
    C = jmoe._capacity(mc, T)
    logits = (xt.astype(jnp.float32)) @ params["router"]
    probs = jax.nn.softmax(logits, axis=-1)
    if mc.router == "laminar":
        load = jnp.sum(probs, axis=0) / jnp.maximum(T, 1)
        logits = logits - mc.laminar_gamma * jnp.log2(1.0 + load * E)[None, :]
        probs = jax.nn.softmax(logits, axis=-1)
    n_rounds = mc.top_k + (mc.laminar_bounces if mc.router == "laminar" else 0)
    scores, used = logits, jnp.zeros((E,), jnp.int32)
    granted = jnp.zeros((T,), jnp.int32)
    experts, kept_all = [], []
    for _ in range(n_rounds):
        need = granted < mc.top_k
        e, kept, pos, used = jmoe._assign_round(scores, used, C, need, cfg.moe_assoc_scan)
        experts.append(np.asarray(e))
        kept_all.append(np.asarray(kept))
        granted = granted + kept.astype(jnp.int32)
        scores = jnp.where(
            jax.nn.one_hot(e, E, dtype=bool) & (need & jnp.isfinite(scores.max(-1)))[:, None],
            -jnp.inf, scores,
        )
    return np.stack(experts), np.stack(kept_all)


def jax_serve(cfg, params, *, requests=24, replicas=2, ticks=120, seed=0):
    """A replica of ``repro/launch/serve.py``'s loop (its ``main`` has no
    function to call), line for line. Returns the scheduler, each request's
    emitted tokens, the prompts, and for each request the top-2 margin of
    the reference's logits at each of its emitted tokens."""
    from repro.models import lm as jlm
    from repro.sched.serving import LaminarServingScheduler, ServeConfig

    rng = np.random.default_rng(seed)
    scfg = ServeConfig(pages_per_replica=128, max_slots=4)
    sched = LaminarServingScheduler(scfg, num_replicas=replicas, seed=seed)

    S_MAX = 96
    decode = jax.jit(lambda p, t, i, c: jlm.decode_step(cfg, p, t, i, c))
    prompts, positions, emitted, margins = {}, {}, {}, {}

    submitted = 0
    for _ in range(ticks):
        while submitted < requests and rng.uniform() < 0.5:
            pr = float(rng.choice([8.0, 32.0, 128.0]))
            rid = sched.submit(
                prompt_len=int(rng.integers(4, 16)),
                max_new=int(rng.integers(4, 12)), priority=pr,
            )
            prompts[rid] = jax.random.randint(
                jax.random.PRNGKey(rid), (1, sched.requests[rid].prompt_len),
                0, cfg.vocab,
            )
            emitted[rid], margins[rid] = [], []
            submitted += 1
        actions = sched.tick()
        for rid in actions["prefill"]:
            sched.on_prefill_done(rid)
            positions[rid] = prompts[rid].shape[1]
        for ri in range(replicas):
            running = sched.running(ri)
            if not running:
                continue
            toks = jnp.concatenate(
                [
                    prompts[rid][:, -1:]
                    if not emitted[rid]
                    else jnp.asarray([[emitted[rid][-1]]])
                    for rid in running
                ],
                axis=0,
            )
            cache = jlm.init_cache(cfg, toks.shape[0], S_MAX)
            logits, _ = decode(
                params, toks, jnp.asarray(positions[running[0]], jnp.int32), cache
            )
            nxt = jnp.argmax(logits[:, 0], axis=-1)
            top2 = np.sort(np.asarray(logits[:, 0]), axis=-1)[:, -2:]
            for j, rid in enumerate(running):
                emitted[rid].append(int(nxt[j]))
                margins[rid].append(float(top2[j, 1] - top2[j, 0]))
                sched.on_token(rid)
    return sched, emitted, {r: np.asarray(p) for r, p in prompts.items()}, margins


def serving_drive(sched, ticks, submit_rate, rng, hi_frac=0.2):
    """``benchmarks/bench_serving.py``'s ``drive``, line for line (the
    benchmarks are not a package the tests import): Poisson arrivals of
    mixed priorities, an ideal data plane (prefill done at once, one token
    a tick for every running sequence)."""
    for _ in range(ticks):
        for _ in range(rng.poisson(submit_rate)):
            hi = rng.uniform() < hi_frac
            sched.submit(
                prompt_len=int(rng.integers(16, 128)),
                max_new=int(rng.integers(8, 64)),
                priority=256.0 if hi else float(rng.choice([4.0, 8.0, 16.0])),
            )
        actions = sched.tick()
        for rid in actions["prefill"]:
            sched.on_prefill_done(rid)
        for ri in range(len(sched.replicas)):
            for rid in list(sched.running(ri)):
                sched.on_token(rid)
    return sched
