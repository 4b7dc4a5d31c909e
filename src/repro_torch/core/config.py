"""Static configuration for the Laminar engine and its baselines.

A copy of ``repro.core.config`` with every field and default equal, except
``use_pallas``, which is gone: here the device of the tensors picks the
kernel (CUDA) or its plain PyTorch version (CPU), see ``core.hotpath``.
Every field is a static Python value that the tick functions read as such.

Defaults follow §V-A of the paper. Times are expressed in milliseconds here and
converted to integer ticks by the engine (tick = ``dt_ms``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch.workloads.scenario import ScenarioConfig

MS = 1.0  # readability alias: all *_ms fields are in milliseconds

# ---------------------------------------------------------------------------
# workload classes (tiers): prod / batch / best-effort (§III-H, ROADMAP 1)
# ---------------------------------------------------------------------------
# Tier codes order eviction preference: higher code = lower class = evicted
# first. The survival scan enforces strict tier precedence ahead of the
# (score, slot) victim key when Airlock is on; kernel-style OOM kills stay
# tier-blind (that contrast is what Exp8 measures).
NUM_TIERS = 3
TIER_NAMES: Tuple[str, ...] = ("prod", "batch", "be")

# Named arrival tier mixes for Exp8 (probabilities over prod/batch/be).
TIER_MIXES: dict = {
    "balanced": (0.3, 0.4, 0.3),
    "prod_heavy": (0.6, 0.3, 0.1),
    "be_heavy": (0.1, 0.3, 0.6),
}


@dataclasses.dataclass(frozen=True)
class WorkloadConfig:
    """Bimodal open-loop Poisson workload (§V-A)."""

    # Class mix: F-tasks (fine-grained transient) vs L-tasks (large-footprint).
    f_share: float = 0.8

    # F-tasks: dispersed atoms, exponential service, low-ms mean.
    f_masses: Tuple[int, ...] = (1, 2, 4)
    f_mass_probs: Tuple[float, ...] = (0.5, 0.3, 0.2)
    f_service_mean_ms: float = 5.0
    f_priorities: Tuple[float, ...] = (24.0, 48.0, 96.0)
    f_priority_probs: Tuple[float, ...] = (0.5, 0.35, 0.15)

    # L-tasks: strictly contiguous atom runs, lognormal (heavy-tail) service.
    l_masses: Tuple[int, ...] = (4, 8, 12)
    l_mass_probs: Tuple[float, ...] = (0.5, 0.3, 0.2)
    l_service_median_ms: float = 30.0
    l_service_sigma: float = 0.8  # lognormal sigma (heavier tail than exp)
    l_priorities: Tuple[float, ...] = (64.0, 128.0, 256.0)
    l_priority_probs: Tuple[float, ...] = (0.5, 0.3, 0.2)

    # Fraction of arrivals that are squatters (Exp4): win arbitration but never
    # complete payload pull. 0.0 disables.
    squatter_ratio: float = 0.0

    # Workload-class (tier) mix over (prod, batch, best-effort) and the
    # tier multiplier applied to the utility weight ev = prio * mass.
    tier_probs: Tuple[float, ...] = TIER_MIXES["balanced"]
    tier_ev_mult: Tuple[float, ...] = (4.0, 1.0, 0.25)

    def mean_atom_seconds_per_task(self) -> float:
        """Expected atom-seconds consumed per arriving task (for lambda calc)."""
        import math

        f_mass = sum(m * p for m, p in zip(self.f_masses, self.f_mass_probs))
        l_mass = sum(m * p for m, p in zip(self.l_masses, self.l_mass_probs))
        l_mean_ms = self.l_service_median_ms * math.exp(
            0.5 * self.l_service_sigma**2
        )
        return (
            self.f_share * (self.f_service_mean_ms / 1e3) * f_mass
            + (1.0 - self.f_share) * (l_mean_ms / 1e3) * l_mass
        )


@dataclasses.dataclass(frozen=True)
class MemoryConfig:
    """Exp5 dynamic memory perturbation + Airlock watermarks."""

    enabled: bool = False
    high_watermark: float = 0.90  # above: throttle admission, begin suspension
    safe_watermark: float = 0.80  # below: resume allowed / suspension stops
    kill_watermark: float = 1.00  # above (airlock off): kernel-style OOM kill
    overclaim_prob: float = 0.3
    overclaim_max: float = 0.5  # true usage up to (1 + overclaim_max) x declared
    drift_kappa: float = 0.10  # slow per-node drift magnitude (fraction of cap)
    noise_sigma: float = 0.10  # per-tick Gaussian noise on ambient pressure
    burst_rate: float = 0.02  # per-node per-tick Bernoulli burst probability
    burst_scale: float = 0.25  # burst adds U(0, burst_scale) of capacity
    ambient_decay: float = 0.98  # ambient perturbation AR(1) decay per tick
    suspended_residual: float = 0.30  # compressed glass-state residual memory
    mem_per_atom: float = 1.0  # declared memory units per resource atom


@dataclasses.dataclass(frozen=True)
class LaminarConfig:
    """Full Laminar engine configuration (§III, §IV, §V-A)."""

    # --- cluster geometry -------------------------------------------------
    num_nodes: int = 2048
    atoms_per_node: int = 64  # two uint32 bitmap words per node
    zone_size: int = 256  # target zone size (heterogeneous if jitter > 0)
    zone_size_jitter: float = 0.20
    # Rigid-topology pre-occupancy painted into node bitmaps at init
    rigid_frac_lo: float = 0.30
    rigid_frac_hi: float = 0.60
    rigid_chunks: int = 3  # contiguous chunks per node -> fragmentation

    # --- time base --------------------------------------------------------
    dt_ms: float = 0.5  # one tick == one network hop (RTT 0.5 ms)
    horizon_ms: float = 2000.0
    hop_loss: float = 0.01  # physical control-packet loss per hop

    # --- capacity of the probe table (structure-of-arrays) -----------------
    probe_capacity: int = 8192
    max_arrivals_per_tick: int = 512

    # --- TEG (entry layer) --------------------------------------------------
    teg_refresh_ms: float = 10.0  # zone-aggregate refresh ("heartbeat")
    teg_temperature: float = 1.0  # tau in P(z) = 2^(U_z/tau) / sum

    # --- Z-HAF (zone layer) -------------------------------------------------
    report_interval_ms: float = 10.0  # node -> Z-HAF state report base interval
    report_jitter_frac: float = 0.2  # Gaussian jitter sigma as frac of interval
    sense_delay_ms: float = 10.0  # tau_i used in Taylor projection
    deriv_ema: float = 0.3  # EMA weight for first-order derivatives
    projection: bool = True  # Taylor projection on/off (ablation)
    degrade_after_ms: float = 50.0  # long-degrade: silence beyond this degrades
    degrade_halflife_ms: float = 50.0  # S halves / H doubles per halflife silent
    extra_sync_delay_ms: float = 0.0  # Exp3: injected synchronization delay

    # --- DA (probe) ----------------------------------------------------------
    candidate_k: int = 8  # bounded in-Zone candidate scan
    addr_noise_sigma: float = 0.5  # epsilon_j symmetry-breaking noise
    # Controlled sub-optimality (§II-C): if the launchpad itself is feasible,
    # bounce only when the best remote candidate beats it by this many bits.
    stay_margin: float = 1.0
    gamma_repulsion: float = 1.0  # thermal repulsion strength (utility + Addr)
    eval_cost: float = 3.0  # patience units per candidate-set evaluation
    bounce_cost: float = 6.0  # patience units per physical bounce
    fastfail_floor: float = 1.0  # Fast-Fail below this patience
    probe_ttl_ms: float = 150.0  # DA silence TTL
    regen_quiet_ms: float = 150.0  # inter-regeneration quiet interval
    regen_cap: int = 5  # max regenerated instances per task
    regeneration: bool = True  # DA regeneration on/off (Exp4)

    # --- node arbitration / two-phase reservation ----------------------------
    arb_rounds: int = 3  # admission rounds per node per tick (§IV-D: the node
    # "proceeds to the next feasible candidate" after each reservation)
    alloc_policy: str = "best"  # "best" (anti-fragmentation) | "first" (paper)
    two_phase: bool = True  # TTL-bounded reservation + payload pull (Exp4)
    deposit: float = 50.0  # frozen patience deposit while pending
    pull_ttl_ms: float = 200.0  # destination pull-valid window
    f_pull_mean_ms: float = 1.0  # payload pull duration (exp mean), F-tasks
    l_pull_mean_ms: float = 3.0  # payload pull duration (exp mean), L-tasks
    task_timeout_ms: float = 500.0  # absolute arrival->start timeout (Laminar)

    # --- Airlock runtime survival (§III-H) ------------------------------------
    airlock: bool = False
    t_susp_ms: float = 40.0  # in-situ recovery preference window
    t_surv_ms: float = 120.0  # shared survival TTL after reactivation
    state_pull_ms_per_atom: float = 1.0  # suspended-state transfer cost
    suspend_rounds_per_tick: int = 1  # residents suspended per node per tick

    # --- workload / memory ----------------------------------------------------
    workload: WorkloadConfig = dataclasses.field(default_factory=WorkloadConfig)
    memory: MemoryConfig = dataclasses.field(default_factory=MemoryConfig)

    # --- scenario: arrival-rate schedule + node disruption process --------------
    # (the default is the stationary, disruption-free scenario, the only one
    # this package's engine runs so far)
    scenario: ScenarioConfig = dataclasses.field(default_factory=ScenarioConfig)

    # --- offered load -----------------------------------------------------------
    rho: float = 0.8  # offered load vs ideal sustainable throughput

    # --- control-work accounting (ns per op; §V-A measured constants) -----------
    ns_bitmap_check: float = 4.02
    ns_utility_score: float = 13.7
    ns_zone_aggregate: float = 29.3

    # ---------------------------------------------------------------------
    @property
    def num_ticks(self) -> int:
        return int(round(self.horizon_ms / self.dt_ms))

    def ticks(self, ms: float) -> int:
        return max(1, int(round(ms / self.dt_ms)))

    @property
    def num_zones(self) -> int:
        """A-priori zone-count estimate for buffer sizing.

        Ceiling division: a non-divisible geometry pads the trailing partial
        zone instead of truncating it, so every node is covered by a zone.
        (The true zone count, after jitter, is ``len(state.zcount)``.)
        """
        return max(1, -(-self.num_nodes // self.zone_size))

    def arrival_rate_per_s(self, free_atoms: float) -> float:
        """Open-loop lambda such that rho = lambda / mu (mu = ideal capacity)."""
        mu = free_atoms / self.workload.mean_atom_seconds_per_task()
        return self.rho * mu


@dataclasses.dataclass(frozen=True)
class BaselineConfig:
    """Shared knobs for the three optimistic baseline models (§V-A)."""

    task_timeout_ms: float = 5000.0  # granted to Ray-like / Flux-like
    heartbeat_ms: float = 10.0  # global state-sync heartbeat
    hop_ms: float = 0.5  # inter-node hop delay

    # Slurm-like (coordination-bound)
    slurm_scan_us_per_node: float = 0.01
    slurm_match_us: float = 0.1
    slurm_mutex_us: float = 0.5
    slurm_convoy_depth: int = 10_000  # lock-convoy activation depth
    slurm_convoy_power: float = 2.0  # mutex cost x (q/depth)^power beyond depth
    slurm_retries: int = 3
    slurm_backoff_ms: float = 2.0
    slurm_queue_capacity: int = 1 << 18  # "unbounded" in-memory FIFO concession

    # Ray-like (retry-bound)
    ray_local_us: float = 20.0
    ray_gcs_us: float = 50.0
    ray_gcs_shards: int = 32
    ray_hotspot_skew: float = 0.5  # fraction of spillback hitting one shard
    ray_usl_depth: int = 500  # USL penalty activation (queued spillbacks)
    ray_usl_sigma: float = 0.05  # USL contention coefficient
    ray_usl_kappa: float = 0.02  # USL coherence coefficient
    ray_redirect_ms: float = 0.5

    # Flux-like (structure-bound)
    flux_fanout: int = 16
    flux_leaf_capacity: int = 32  # concurrent tasks a leaf broker handles
    flux_dispatch_us_per_level: float = 1.0
    flux_leaf_scan_us: float = 0.005
    flux_root_choke: int = 4000  # exponential congestion beyond this
    flux_root_choke_scale: float = 2000.0
    flux_rollback_hop_ms: float = 0.5
    flux_backoff_ms_per_level: float = 10.0
