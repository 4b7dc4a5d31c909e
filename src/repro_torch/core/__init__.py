"""Laminar core, ported to PyTorch: probe-first, execute-later scheduling
with runtime survival, as plain functions on tensors on one device.

  * :mod:`repro_torch.core.teg`      — Thermo-Economic Gateway
  * :mod:`repro_torch.core.zhaf`     — Zone Holographic Availability Field
  * :mod:`repro_torch.core.da`       — Decentralized Agent lifecycle
  * :mod:`repro_torch.core.arbiter`  — node-local arbitration + two-phase reservation
  * :mod:`repro_torch.core.airlock`  — bounded runtime survival
  * :mod:`repro_torch.core.draws`    — per-tick random values
  * :mod:`repro_torch.core.engine`   — the tick loop
"""

from repro_torch.core.config import (
    BaselineConfig,
    LaminarConfig,
    MemoryConfig,
    WorkloadConfig,
)
from repro_torch.core.engine import LaminarEngine
from repro_torch.workloads import (
    SCENARIOS,
    DisruptionConfig,
    ScenarioConfig,
    ScheduleConfig,
)

__all__ = [
    "BaselineConfig",
    "DisruptionConfig",
    "LaminarConfig",
    "MemoryConfig",
    "SCENARIOS",
    "ScenarioConfig",
    "ScheduleConfig",
    "WorkloadConfig",
    "LaminarEngine",
]
