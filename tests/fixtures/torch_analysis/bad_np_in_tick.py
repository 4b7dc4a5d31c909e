"""LC102 fixture: numpy applied to a tensor inside a tick function."""

from __future__ import annotations

import numpy as np
import torch


def make_step(cfg):
    def step(x: torch.Tensor, d):
        return x / np.linalg.norm(x)  # LC102: numpy on a tensor

    return step
