"""Tick-indexed arrival-rate schedules, a port of ``repro.workloads.schedule``.

Each schedule is a pure function of the tick ``t`` (and, for ``mmpp``, of
the burst state of ``t``'s dwell segment): a dimensionless factor on the base
per-tick intensity ``lam_base``; :func:`rate_per_tick` clips the product into
``[0, lam_base * lam_max_factor]``.

* ``stationary`` — factor 1.
* ``mmpp`` — two-state Markov-modulated Poisson: time is cut into dwell
  segments, each independently in the burst state with ``mmpp_burst_prob``,
  giving ``mmpp_hi_factor`` there and ``mmpp_lo_factor`` otherwise. The burst
  state is ONE draw per segment: :func:`burst_states` makes them from the
  seed, and every tick of a segment reads the same one.
* ``diurnal`` — ``1 + A * sin(2*pi*t/T)``; periodic with period ``T``.
* ``flash`` — ``1 + amplitude`` inside a width-``w`` window at the start of
  every period, 1 elsewhere; periodic.

The JAX package draws the burst states from ``fold_in(key, segment)``; here
they come from numpy, so the two packages agree on the factor for given
burst states, not on the states themselves.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.workloads.scenario import KINDS, ScheduleConfig

# Salt mixed into the seed of the per-run schedule stream, so the schedule
# is independent of every per-tick draw (as ``repro.workloads.schedule``)
SCHED_SALT = 0x5CED


def _ticks(ms: float, dt_ms: float) -> int:
    return max(1, int(round(ms / dt_ms)))


def segment(sched: ScheduleConfig, t, dt_ms: float):
    """The mmpp dwell segment of tick ``t`` (int or int tensor)."""
    return t // _ticks(sched.mmpp_dwell_ms, dt_ms)


def burst_states(sched: ScheduleConfig, seed: int, num_segments: int) -> np.ndarray:
    """(num_segments,) bool: whether each mmpp segment is in the burst state.

    Segment ``k``'s state depends only on ``(seed, k)``: the values are the
    prefix of one stream, so asking for more segments keeps the first ones."""
    u = np.random.default_rng([SCHED_SALT, seed]).random(num_segments)
    return u < sched.mmpp_burst_prob


def diurnal_phase(sched: ScheduleConfig, t: torch.Tensor, dt_ms: float) -> torch.Tensor:
    """``2 pi (t mod T) / T`` at ticks ``t`` (int tensor) -> float32.

    Formed as ``x * c`` with ``c = float32(2 pi / T)`` folded on the host,
    as the jitted JAX package forms it (XLA folds the constants of
    ``2 pi x / T`` into one product): bit-equal to its phase. On CUDA,
    PyTorch would turn a division by a Python scalar into a product with
    its reciprocal anyway, so one constant also gives the card and the CPU
    one phase."""
    period = _ticks(sched.diurnal_period_ms, dt_ms)
    c = float(np.float32(2.0 * math.pi / period))
    return (t % period).to(torch.float32) * c


def rate_factor(
    sched: ScheduleConfig, t: torch.Tensor, burst: torch.Tensor | None, dt_ms: float
) -> torch.Tensor:
    """Dimensionless rate multiplier at ticks ``t`` (int tensor) -> float32.

    ``burst`` (bool, shaped like ``t``) is the burst state of each tick's
    segment; only ``mmpp`` reads it."""
    one = torch.ones(t.shape, dtype=torch.float32, device=t.device)
    if sched.kind == "stationary":
        return one
    if sched.kind == "mmpp":
        return torch.where(burst, sched.mmpp_hi_factor, sched.mmpp_lo_factor * one)
    if sched.kind == "diurnal":
        return 1.0 + sched.diurnal_amplitude * torch.sin(diurnal_phase(sched, t, dt_ms))
    if sched.kind == "flash":
        period = _ticks(sched.flash_period_ms, dt_ms)
        width = _ticks(sched.flash_width_ms, dt_ms)
        return torch.where((t % period) < width, 1.0 + sched.flash_amplitude, one)
    raise ValueError(f"unknown schedule kind: {sched.kind!r} (one of {KINDS})")


def rate_per_tick(
    sched: ScheduleConfig,
    lam_base: float,
    t: torch.Tensor,
    burst: torch.Tensor | None,
    dt_ms: float,
) -> torch.Tensor:
    """Per-tick arrival intensity, clipped into ``[0, lam_base * lam_max]``."""
    factor = rate_factor(sched, t, burst, dt_ms)
    lam = torch.full((), lam_base, dtype=torch.float32, device=t.device)
    hi = float(np.float32(lam_base * sched.lam_max_factor))
    return torch.clamp(lam * factor, 0.0, hi)


def schedule_period_ticks(sched: ScheduleConfig, dt_ms: float) -> int | None:
    """Claimed period in ticks (None where the schedule is not periodic)."""
    if sched.kind == "diurnal":
        return _ticks(sched.diurnal_period_ms, dt_ms)
    if sched.kind == "flash":
        return _ticks(sched.flash_period_ms, dt_ms)
    if sched.kind == "stationary":
        return 1
    return None  # mmpp: random segment states, not periodic
