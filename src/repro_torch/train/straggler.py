"""Straggler mitigation + failure detection for the training loop.

On real multi-pod deployments step times are measured per host; here the
monitor consumes injected step durations (tests) or wall-clock measurements
(examples). Policy:

  * EWMA + deviation tracking of step time;
  * a step slower than ``threshold x`` the EWMA marks a straggler incident;
  * ``trip_after`` consecutive incidents trips the breaker -> the trainer
    treats the host as failed and triggers elastic re-meshing (the same
    path a hard failure takes), mirroring Laminar's short-project /
    long-degrade rule: brief slowness is absorbed, sustained slowness is
    conservatively removed from the candidate set.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class StragglerMonitor:
    threshold: float = 2.0
    trip_after: int = 3
    ema_alpha: float = 0.2
    _ema: float = 0.0
    _incidents: int = 0
    steps: int = 0
    tripped: bool = False

    def observe(self, step_time_s: float) -> str:
        """Returns 'ok' | 'straggler' | 'tripped'."""
        self.steps += 1
        if self._ema == 0.0:
            self._ema = step_time_s
            return "ok"
        slow = step_time_s > self.threshold * self._ema
        # slow steps do not poison the baseline (long-degrade, not re-learn)
        if not slow:
            self._ema = (1 - self.ema_alpha) * self._ema + self.ema_alpha * step_time_s
            self._incidents = 0
            return "ok"
        self._incidents += 1
        if self._incidents >= self.trip_after:
            self.tripped = True
            return "tripped"
        return "straggler"

    def reset(self) -> None:
        self._incidents = 0
        self.tripped = False
