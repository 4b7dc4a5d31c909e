"""Assigned input-shape set (identical for every LM-family arch): a port of
``repro.configs.shapes``.

  train_4k     seq 4,096   global batch 256   -> train_step
  prefill_32k  seq 32,768  global batch 32    -> prefill (inference)
  decode_32k   seq 32,768  global batch 128   -> serve_step (1 token, KV=32k)
  long_500k    seq 524,288 global batch 1     -> serve_step, sub-quadratic only
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"
    subquadratic_only: bool = False


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode", subquadratic_only=True),
}

# archs whose decode is sub-quadratic in context (fixed-size state and/or
# bounded local window): the only ones that run long_500k.
SUBQUADRATIC_ARCHS: Tuple[str, ...] = ("recurrentgemma-2b", "mamba2-130m")


def cells(arch_names):
    """All (arch, shape) cells incl. skip markers. Yields (arch, shape, skip)."""
    for a in arch_names:
        for s in SHAPES.values():
            skip = s.subquadratic_only and a not in SUBQUADRATIC_ARCHS
            yield a, s, skip
