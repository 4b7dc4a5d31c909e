"""Plain PyTorch version of the node_view kernel: the view build it replaced.

The chain ``core.zhaf.build_view`` ran before the kernel, as the JAX
package's ``repro.core.zhaf.build_view`` runs it: the words unpacked into a
bit plane, its sum and its longest run (``bitmap.max_run``), as float32.
"""

from __future__ import annotations

import torch

from repro_torch.core import bitmap


def node_view_ref(words: torch.Tensor, *, atoms: int):
    """(free atoms, longest free run), each float32 ``(...)``, of the
    ``(..., W)`` int32 words whose first ``atoms`` bits are atoms."""
    bits = bitmap.unpack_bits(words, atoms)
    s = torch.sum(bits, dim=-1).to(torch.float32)
    return s, bitmap.max_run(bits).to(torch.float32)
