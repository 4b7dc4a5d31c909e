"""Scenario configuration (schedules, disruption, presets) for the port."""

from repro_torch.workloads.scenario import (
    KINDS,
    SCENARIOS,
    DisruptionConfig,
    ScenarioConfig,
    ScheduleConfig,
)

__all__ = [
    "KINDS",
    "SCENARIOS",
    "DisruptionConfig",
    "ScenarioConfig",
    "ScheduleConfig",
]
