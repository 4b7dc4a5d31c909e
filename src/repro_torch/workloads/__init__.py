"""Scenarios for the port: configuration and presets (``scenario``), the
arrival-rate schedules (``schedule``) and the node disruption process
(``disruption``)."""

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
