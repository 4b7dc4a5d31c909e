"""Per-tick random values of the engine, drawn apart from the tick.

Every random value one tick of the JAX engine consumes has a fixed shape and
does not depend on the state (``repro.core``: ``engine.py:66,161``,
``workload.py:45-84``, ``zhaf.py:69-90``, ``airlock.py:42-50``,
``da.py:66,116-141``, ``teg.py:70-87``, ``workloads/disruption.py:57-63``).
So the tick of this package takes them as one :class:`Draws` value, already
pushed through their distribution (after ``poisson``, ``choice``, ``gumbel``
and the rest), and a provider hands one ``Draws`` per tick.

The scenario shapes the draws, never the state: the Poisson count is drawn
at the schedule's rate for tick ``t``, disruption adds two values per tick,
and its eviction headroom widens TEG's dispatch rows (:func:`max_dispatch`).

:class:`TorchDraws` samples the same distributions from one
``torch.Generator``. :class:`ArrayDraws` hands out values recorded
beforehand, such as those of a replay of the JAX package's key schedule.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.config import LaminarConfig
from repro_torch.workloads import schedule as wl_schedule


class Draws(NamedTuple):
    # airlock.memory_dynamics: ambient noise and bursts, (N,)
    mem_noise: torch.Tensor  # standard normal
    burst_u: torch.Tensor  # uniform: burst happens if < burst_rate
    burst_v: torch.Tensor  # uniform: burst size
    # zhaf.report, (N,)
    rep_loss: torch.Tensor  # uniform: delivered if >= hop_loss
    rep_jit: torch.Tensor  # standard normal report jitter
    # workload.sample_arrivals + engine._inject_arrivals
    arr_n: torch.Tensor  # () int32 Poisson(lam) arrival count (before the cap)
    arr_l: torch.Tensor  # (n_max,) uniform: L-task if >= f_share
    arr_squat: torch.Tensor  # (n_max,) uniform: squatter if < squatter_ratio
    arr_tier: torch.Tensor  # (n_max,) int32 tier code drawn from tier_probs
    arr_mass_f: torch.Tensor  # (n_max,) f32 F-task mass drawn from f_masses
    arr_mass_l: torch.Tensor  # (n_max,) f32 L-task mass drawn from l_masses
    arr_pri_f: torch.Tensor  # (n_max,) f32 F-task priority
    arr_pri_l: torch.Tensor  # (n_max,) f32 L-task priority
    arr_svc_exp: torch.Tensor  # (n_max,) standard exponential (F service)
    arr_svc_norm: torch.Tensor  # (n_max,) standard normal (L service)
    arr_pull_exp: torch.Tensor  # (n_max,) standard exponential (pull)
    oc_u: torch.Tensor  # (n_max,) uniform: overclaims if < overclaim_prob
    oc_v: torch.Tensor  # (n_max,) uniform: overclaim size
    # da.move, (P,)
    move_loss: torch.Tensor  # uniform: bounce lost if < hop_loss
    # teg.dispatch
    gumbel: torch.Tensor  # (D, Z) standard Gumbel
    launch_u: torch.Tensor  # (D,) uniform launchpad inside the zone
    # da.address
    cand_u: torch.Tensor  # (P, K - 1) uniform candidates inside the zone
    addr_eps: torch.Tensor  # (P, K) standard normal symmetry breaking
    # workloads.disruption_step, when the scenario's disruption is on
    dis_u: Optional[torch.Tensor] = None  # () uniform: event if < fail_event_prob
    dis_start: Optional[torch.Tensor] = None  # () int32 first node of the block

    def to(self, device) -> "Draws":
        return Draws(*(None if x is None else x.to(device) for x in self))


def max_dispatch(cfg: LaminarConfig) -> int:
    """Rows TEG can dispatch in one tick (arrivals plus headroom)."""
    rows = cfg.max_arrivals_per_tick + 256
    dc = cfg.scenario.disruption
    if dc.enabled and not dc.drain:
        # eviction headroom: a failure event can force at most one resident
        # per atom on each failed node into TEG re-dispatch the same tick
        rows += 2 * dc.fail_block * cfg.atoms_per_node
    return rows


class TorchDraws:
    """One ``Draws`` per tick, sampled from a ``torch.Generator``.

    ``generator_device`` is where the generator lives and samples (default:
    ``device``); the values are then copied to ``device``. Two providers
    built with the same seed and ``generator_device="cpu"`` hand identical
    values to a CPU and a CUDA engine. The draws follow ``cfg.scenario``,
    recorded as ``scenario``; an engine refuses draws made for another.
    """

    def __init__(
        self,
        cfg: LaminarConfig,
        lam_per_tick: float,
        num_zones: int,
        seed: int,
        device,
        generator_device=None,
    ):
        self.cfg = cfg
        self.scenario = cfg.scenario
        self.device = torch.device(device)
        gdev = torch.device(generator_device or device)
        self.gdev = gdev
        self.gen = torch.Generator(device=gdev)
        self.gen.manual_seed(seed)
        self.seed = seed
        self.num_zones = num_zones
        self.lam_base = float(lam_per_tick)
        self.lam = torch.full((), self.lam_base, dtype=torch.float32, device=gdev)
        self._bursts = np.zeros(0, bool)
        w = cfg.workload

        def cdf(probs):
            p = torch.tensor(probs, dtype=torch.float32, device=gdev)
            return torch.cumsum(p / p.sum(), 0)

        def vals(values):
            return torch.tensor(values, dtype=torch.float32, device=gdev)

        self._tier = cdf(w.tier_probs)
        self._mass_f = (cdf(w.f_mass_probs), vals(w.f_masses))
        self._mass_l = (cdf(w.l_mass_probs), vals(w.l_masses))
        self._pri_f = (cdf(w.f_priority_probs), vals(w.f_priorities))
        self._pri_l = (cdf(w.l_priority_probs), vals(w.l_priorities))

    def _u(self, *shape):
        return torch.rand(shape, generator=self.gen, device=self.gdev)

    def _n(self, *shape):
        return torch.randn(shape, generator=self.gen, device=self.gdev)

    def _e(self, *shape):
        x = torch.empty(shape, device=self.gdev)
        return x.exponential_(generator=self.gen)

    def _index(self, cdf, n):
        # inverse-CDF categorical draw
        i = torch.searchsorted(cdf, self._u(n), right=True)
        return torch.clamp(i, max=cdf.shape[0] - 1)

    def _choice(self, table, n):
        cdf, values = table
        return values[self._index(cdf, n)]

    def _rate(self, t: int) -> torch.Tensor:
        """The Poisson intensity of tick ``t`` under the scenario's schedule."""
        sched = self.scenario.schedule
        if sched.kind == "stationary":
            return self.lam
        burst = None
        if sched.kind == "mmpp":
            seg = wl_schedule.segment(sched, t, self.cfg.dt_ms)
            if seg >= len(self._bursts):  # one draw per segment, by (seed, seg)
                self._bursts = wl_schedule.burst_states(sched, self.seed, 2 * seg + 64)
            burst = torch.full((), bool(self._bursts[seg]), device=self.gdev)
        tt = torch.full((), t, dtype=torch.int32, device=self.gdev)
        return wl_schedule.rate_per_tick(sched, self.lam_base, tt, burst, self.cfg.dt_ms)

    def tick(self, t: int) -> Draws:
        cfg = self.cfg
        N, P = cfg.num_nodes, cfg.probe_capacity
        n_max, K = cfg.max_arrivals_per_tick, cfg.candidate_k
        D = max_dispatch(cfg)
        tiny = torch.finfo(torch.float32).tiny
        gumbel = -torch.log(-torch.log(torch.clamp(self._u(D, self.num_zones), min=tiny)))
        d = Draws(
            mem_noise=self._n(N),
            burst_u=self._u(N),
            burst_v=self._u(N),
            rep_loss=self._u(N),
            rep_jit=self._n(N),
            arr_n=torch.poisson(self._rate(t), generator=self.gen).to(torch.int32),
            arr_l=self._u(n_max),
            arr_squat=self._u(n_max),
            arr_tier=self._index(self._tier, n_max).to(torch.int32),
            arr_mass_f=self._choice(self._mass_f, n_max),
            arr_mass_l=self._choice(self._mass_l, n_max),
            arr_pri_f=self._choice(self._pri_f, n_max),
            arr_pri_l=self._choice(self._pri_l, n_max),
            arr_svc_exp=self._e(n_max),
            arr_svc_norm=self._n(n_max),
            arr_pull_exp=self._e(n_max),
            oc_u=self._u(n_max),
            oc_v=self._u(n_max),
            move_loss=self._u(P),
            gumbel=gumbel,
            launch_u=self._u(D),
            cand_u=self._u(P, K - 1),
            addr_eps=self._n(P, K),
        )
        if self.scenario.disruption.enabled:
            d = d._replace(
                dis_u=self._u(),
                dis_start=torch.randint(
                    0, N, (), generator=self.gen, device=self.gdev, dtype=torch.int32
                ),
            )
        if self.gdev != self.device:
            d = d.to(self.device)
        return d


class ArrayDraws:
    """``Draws`` recorded beforehand: ``arrays`` maps each field of
    :class:`Draws` to a numpy array whose leading axis is the tick (absent
    optional fields are left out). Holds numpy only, so it can be pickled to
    worker processes."""

    def __init__(self, arrays: Dict[str, np.ndarray], device="cpu"):
        self.arrays = arrays
        self.device = torch.device(device)

    def tick(self, t: int) -> Draws:
        return Draws(
            **{k: torch.from_numpy(np.array(v[t])) for k, v in self.arrays.items()}
        ).to(self.device)
