"""Correlated node disruption process, a port of ``repro.workloads.disruption``.

A pure fixed-shape transition over the carried per-node state
``(node_up, down_until)``. A failure event takes out one contiguous block of
``fail_block`` nodes (wrapping at the array edge); each downed node recovers
deterministically ``downtime_ms`` later. Applying the resulting masks to the
engine's tables is ``repro_torch.core.disrupt``.

The two random values of a tick (the event uniform and the block start) come
from the tick's ``Draws``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .scenario import DisruptionConfig
from .schedule import _ticks


def disruption_step(
    d: DisruptionConfig,
    node_up: torch.Tensor,  # (N,) bool
    down_until: torch.Tensor,  # (N,) i32 recovery tick for down nodes
    t: torch.Tensor,  # () i32
    event_u: torch.Tensor,  # () f32 uniform: an event happens if < fail_event_prob
    start: torch.Tensor,  # () i32 first node of the block, in [0, N)
    dt_ms: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One tick of the disruption process.

    Returns ``(node_up', down_until', fail, recover)`` where ``fail`` and
    ``recover`` mark the nodes changing state this tick. Recoveries are
    resolved first, so a block landing on a just-recovered node can take it
    straight back down.
    """
    N = node_up.shape[0]
    recover = ~node_up & (t >= down_until)
    up = node_up | recover

    event = event_u < d.fail_event_prob
    lane = torch.arange(N, dtype=torch.int32, device=node_up.device)
    in_block = ((lane - start) % N) < d.fail_block
    fail = event & in_block & up

    up = up & ~fail
    down_until = torch.where(fail, t + _ticks(d.downtime_ms, dt_ms), down_until)
    return up, down_until, fail, recover
