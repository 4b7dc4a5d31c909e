"""Scenario configuration: an arrival-rate schedule composed with a node
disruption process, plus the named presets.

A jax-free copy of the dataclasses in ``repro.workloads`` (``schedule.py``,
``disruption.py``, ``scenario.py``): the same fields, defaults, presets and
``signature()``. The schedules themselves are ``workloads.schedule``, the
disruption process ``workloads.disruption``.
"""

from __future__ import annotations

import dataclasses

KINDS = ("stationary", "mmpp", "diurnal", "flash")


@dataclasses.dataclass(frozen=True)
class ScheduleConfig:
    """Arrival-rate schedule parameters (all static)."""

    kind: str = "stationary"
    lam_max_factor: float = 8.0  # hard envelope: lam_t <= lam_base * this

    # mmpp (two-state bursty)
    mmpp_dwell_ms: float = 50.0  # segment length
    mmpp_burst_prob: float = 0.3  # P(segment is in the burst state)
    mmpp_lo_factor: float = 0.5
    mmpp_hi_factor: float = 3.0

    # diurnal sinusoid
    diurnal_period_ms: float = 400.0
    diurnal_amplitude: float = 0.8  # 0 <= A <= 1 keeps the factor >= 0

    # flash-crowd spike train
    flash_period_ms: float = 300.0
    flash_width_ms: float = 20.0
    flash_amplitude: float = 5.0  # factor = 1 + amplitude inside the spike


@dataclasses.dataclass(frozen=True)
class DisruptionConfig:
    """Node disruption process parameters (all static)."""

    enabled: bool = False
    fail_event_prob: float = 0.01  # per-tick P(correlated failure event)
    fail_block: int = 8  # contiguous nodes taken out per event
    downtime_ms: float = 80.0  # deterministic outage duration
    drain: bool = False  # True: graceful drain (residents survive)


@dataclasses.dataclass(frozen=True)
class ScenarioConfig:
    """Composition of an arrival schedule and a node disruption process."""

    name: str = "stationary"
    schedule: ScheduleConfig = dataclasses.field(default_factory=ScheduleConfig)
    disruption: DisruptionConfig = dataclasses.field(
        default_factory=DisruptionConfig
    )

    def signature(self) -> tuple:
        """Full flattened parameter tuple (not just the name: two presets
        could share a name)."""
        return dataclasses.astuple(self)


