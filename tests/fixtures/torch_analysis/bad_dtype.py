"""LC202/LC203 fixture: dtype hazards in a recorded tick."""

import torch

from repro_torch.analysis.trace_audit import OpRecorder, audit_ops


def float64_in_tick():
    # a Python float list becomes a float64 tensor (LC202)
    x = torch.ones(4, dtype=torch.float32)
    with OpRecorder() as rec:
        x + torch.tensor([0.5, 0.5, 0.5, 0.5], dtype=torch.float64)
    return audit_ops(rec.ops, subject="toy tick")


def f32_narrowed_to_bf16():
    # accumulate in bf16, cast back: parity-breaking narrowing (LC203)
    x = torch.ones(4, dtype=torch.float32)
    with OpRecorder() as rec:
        (x.to(torch.bfloat16) * 2).to(torch.float32)
    return audit_ops(rec.ops, subject="toy tick")


LAMINAR_CHECK_TARGETS = [float64_in_tick, f32_narrowed_to_bf16]
