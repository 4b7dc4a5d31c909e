"""LC103 fixture: a kernel entry with no ``scale_ref`` twin anywhere.

A port kernel package is an ``ops.py`` with a ``csrc/<package>.cu`` beside
it or above it (here ``../csrc/bad_kernel_pkg.cu``)."""

import torch


def scale(x: torch.Tensor) -> torch.Tensor:  # LC103: no scale_ref twin
    return x * 2.0
