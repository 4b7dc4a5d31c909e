"""LC101 fixture: host syncs inside a tick function, seen by the lint and,
when the tick runs, by the trace plane."""

from __future__ import annotations

import torch

from repro_torch.analysis.trace_audit import OpRecorder, audit_ops
from repro_torch.core.draws import Draws
from repro_torch.core.state import SimState


def make_step(cfg):
    def step(s: SimState, d: Draws):
        total = torch.sum(s.mem)
        if total > 0:  # LC101: Python `if` on a tensor
            s = s._replace(mem=s.mem * 2.0)
        n = s.arrival.max().item()  # LC101: .item()
        busy = s.st == 6
        hot = s.mem[busy]  # LC101: boolean-mask indexing
        return s, hot, n

    return step


def recorded_item_sync():
    # the same `.item()`, recorded as aten._local_scalar_dense
    x = torch.arange(4, dtype=torch.int32)
    with OpRecorder() as rec:
        x.max().item()
    return audit_ops(rec.ops, subject="toy tick")


LAMINAR_CHECK_TARGETS = [recorded_item_sync]
