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

``TorchDraws`` samples the same distributions from one
``torch.Generator``. :class:`ArrayDraws` hands out values recorded
beforehand, such as those of a replay of the JAX package's key schedule.
:class:`BatchDraws` stacks the draws of one provider a seed for the
lockstep engine.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .config import LaminarConfig
from . import schedule as wl_schedule


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


class DrawTables(NamedTuple):
    """The tensors a :class:`TorchDraws` samples with besides its generator:
    the categorical tables of the workload, the arrival intensity and the
    mmpp burst state of each dwell segment. A captured tick samples from
    copies of them (``core.scan``), so every value that differs between two
    providers of one config lives here, on the device, and none in the tick."""

    tier: torch.Tensor  # (T,) cumulative tier_probs
    mass_f: torch.Tensor  # cumulative f_mass_probs
    mass_f_values: torch.Tensor  # f_masses
    mass_l: torch.Tensor
    mass_l_values: torch.Tensor
    pri_f: torch.Tensor
    pri_f_values: torch.Tensor
    pri_l: torch.Tensor
    pri_l_values: torch.Tensor
    lam: torch.Tensor  # () f32 base intensity a tick
    lam_cap: torch.Tensor  # () f32 its envelope, schedule.rate_cap
    bursts: torch.Tensor  # (S,) bool: segment k in the mmpp burst state ((1,) unread otherwise)


class TorchDraws:
    """One ``Draws`` per tick, sampled from a ``torch.Generator``.

    ``generator_device`` is where the generator lives and samples (default:
    ``device``); the values are then copied to ``device``. Two providers
    built with the same seed and ``generator_device="cpu"`` hand identical
    values to a CPU and a CUDA engine. The draws follow ``cfg.scenario``,
    recorded as ``scenario``; an engine refuses draws made for another.

    ``tick(t)`` takes the tick as a Python int or as an int32 device
    tensor: the rate schedule reads it on the device, and the mmpp burst
    states come from a device table (:meth:`cover` makes it span a run), so
    a tick captured in a CUDA graph draws tick ``t``'s values at every
    replay. :meth:`draw` samples from a given generator and tables, which is
    how the compiled run (``core.scan``) samples inside its graph.
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
        w = cfg.workload

        def cdf(probs):
            p = torch.tensor(probs, dtype=torch.float32, device=gdev)
            return torch.cumsum(p / p.sum(), 0)

        def vals(values):
            return torch.tensor(values, dtype=torch.float32, device=gdev)

        def scalar(x):
            return torch.full((), x, dtype=torch.float32, device=gdev)

        self.tables = DrawTables(
            tier=cdf(w.tier_probs),
            mass_f=cdf(w.f_mass_probs), mass_f_values=vals(w.f_masses),
            mass_l=cdf(w.l_mass_probs), mass_l_values=vals(w.l_masses),
            pri_f=cdf(w.f_priority_probs), pri_f_values=vals(w.f_priorities),
            pri_l=cdf(w.l_priority_probs), pri_l_values=vals(w.l_priorities),
            lam=scalar(self.lam_base),
            lam_cap=scalar(wl_schedule.rate_cap(self.scenario.schedule, self.lam_base)),
            bursts=torch.zeros(1, dtype=torch.bool, device=gdev),
        )
        self.cover(1)

    def cover(self, num_ticks: int) -> None:
        """Make the mmpp burst table span ticks ``[0, num_ticks)``: one
        state a dwell segment (``schedule.burst_states``, a prefix of one
        seeded stream, so a longer table keeps the first states), its length
        a power of two of at least 64 segments, so runs of similar lengths
        share one table shape. Other schedules read no table."""
        sched = self.scenario.schedule
        if sched.kind != "mmpp":
            return
        need = int(wl_schedule.segment(sched, max(num_ticks, 1) - 1, self.cfg.dt_ms)) + 1
        have = self.tables.bursts.shape[0]
        if have >= 64 and need <= have:
            return
        n = max(64, 1 << (need - 1).bit_length())
        bursts = torch.from_numpy(wl_schedule.burst_states(sched, self.seed, n))
        if self.gdev.type == "cuda":  # no host sync: a pinned copy, ordered on the stream
            bursts = bursts.pin_memory().to(self.gdev, non_blocking=True)
        self.tables = self.tables._replace(bursts=bursts.to(self.gdev))

    def signature(self) -> tuple:
        """What :meth:`draw` reads besides its generator, tables and tick:
        two providers of one signature draw alike from equal generator
        states and tables."""
        return (type(self).__name__, self.cfg, self.num_zones, str(self.gdev), str(self.device),
                tuple((tuple(x.shape), x.dtype) for x in self.tables))

    def _tick(self, t) -> torch.Tensor:
        """Tick ``t`` as an int32 tensor on the generator's device; a
        Python int first makes the burst table cover it."""
        if isinstance(t, torch.Tensor):
            return t
        self.cover(t + 1)
        return torch.full((), t, dtype=torch.int32, device=self.gdev)

    def _u(self, gen, *shape):
        return torch.rand(shape, generator=gen, device=self.gdev)

    def _n(self, gen, *shape):
        return torch.randn(shape, generator=gen, device=self.gdev)

    def _e(self, gen, *shape):
        x = torch.empty(shape, device=self.gdev)
        return x.exponential_(generator=gen)

    def _index(self, gen, cdf, n):
        # inverse-CDF categorical draw
        i = torch.searchsorted(cdf, self._u(gen, n), right=True)
        return torch.clamp(i, max=cdf.shape[0] - 1)

    def _choice(self, gen, cdf, values, n):
        return values[self._index(gen, cdf, n)]

    def _rate(self, t, tables: DrawTables | None = None) -> torch.Tensor:
        """The Poisson intensity of tick ``t`` (an int, or an int32 tensor)
        under the scenario's schedule."""
        t = self._tick(t)
        tab = self.tables if tables is None else tables
        sched = self.scenario.schedule
        if sched.kind == "stationary":
            return tab.lam
        burst = None
        if sched.kind == "mmpp":  # one draw per segment, by (seed, seg)
            seg = wl_schedule.segment(sched, t, self.cfg.dt_ms)
            burst = torch.take(tab.bursts, seg.long())
        return wl_schedule.rate_per_tick(sched, tab.lam, tab.lam_cap, t, burst, self.cfg.dt_ms)

    def _arrivals(self, t, gen, tab: DrawTables) -> dict:
        """The arrival fields of a tick, drawn in this order (both
        providers' ticks draw them so)."""
        n_max = self.cfg.max_arrivals_per_tick
        out = {"arr_n": torch.poisson(self._rate(t, tab), generator=gen).to(torch.int32)}
        out["arr_l"] = self._u(gen, n_max)
        out["arr_squat"] = self._u(gen, n_max)
        out["arr_tier"] = self._index(gen, tab.tier, n_max).to(torch.int32)
        out["arr_mass_f"] = self._choice(gen, tab.mass_f, tab.mass_f_values, n_max)
        out["arr_mass_l"] = self._choice(gen, tab.mass_l, tab.mass_l_values, n_max)
        out["arr_pri_f"] = self._choice(gen, tab.pri_f, tab.pri_f_values, n_max)
        out["arr_pri_l"] = self._choice(gen, tab.pri_l, tab.pri_l_values, n_max)
        out["arr_svc_exp"] = self._e(gen, n_max)
        out["arr_svc_norm"] = self._n(gen, n_max)
        out["arr_pull_exp"] = self._e(gen, n_max)
        return out

    def tick(self, t) -> Draws:
        """Tick ``t``'s draws (``t`` an int, or an int32 tensor on the
        generator's device within the span :meth:`cover` made)."""
        return self.draw(self._tick(t), self.gen, self.tables)

    def draw(self, t: torch.Tensor, gen: torch.Generator, tab: DrawTables) -> Draws:
        """Tick ``t``'s draws (an int32 tensor) from ``gen`` and ``tab``."""
        cfg = self.cfg
        N, P = cfg.num_nodes, cfg.probe_capacity
        n_max, K = cfg.max_arrivals_per_tick, cfg.candidate_k
        D = max_dispatch(cfg)
        tiny = torch.finfo(torch.float32).tiny
        gumbel = -torch.log(-torch.log(torch.clamp(self._u(gen, D, self.num_zones), min=tiny)))
        d = Draws(
            mem_noise=self._n(gen, N),
            burst_u=self._u(gen, N),
            burst_v=self._u(gen, N),
            rep_loss=self._u(gen, N),
            rep_jit=self._n(gen, N),
            **self._arrivals(t, gen, tab),
            oc_u=self._u(gen, n_max),
            oc_v=self._u(gen, n_max),
            move_loss=self._u(gen, P),
            gumbel=gumbel,
            launch_u=self._u(gen, D),
            cand_u=self._u(gen, P, K - 1),
            addr_eps=self._n(gen, P, K),
        )
        if self.scenario.disruption.enabled:
            d = d._replace(
                dis_u=self._u(gen),
                dis_start=torch.randint(
                    0, N, (), generator=gen, device=self.gdev, dtype=torch.int32
                ),
            )
        if self.gdev != self.device:
            d = d.to(self.device)
        return d
