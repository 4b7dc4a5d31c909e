"""Per-tick random values of the baseline models, drawn apart from the step.

The port's counterpart of ``core.draws`` for ``repro.core.baselines``. Every
random value one step of a reference baseline consumes has a fixed shape and
does not depend on the state: the arrivals (``workload.sample_arrivals``),
the disruption (``workloads.disruption.disruption_step``) and each model's
own draws over the task table of capacity C (``ray_like.py:67,87,130``,
``flux_like.py:102,106``). So a step takes them as one
:class:`BaselineDraws`, already pushed through their distribution, and a
provider hands one per tick. The scenario's arrival schedule shapes the
Poisson count; the draws record the model, scenario and capacity they were
made for, and a run refuses others (``common.check_draws``).

:class:`TorchBaselineDraws` samples the same distributions from one
``torch.Generator``; :class:`ArrayBaselineDraws` hands out values recorded
beforehand.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.config import LaminarConfig
from repro_torch.core.draws import DrawTables, TorchDraws

MODELS = ("slurm", "ray", "flux")
RAY_CANDIDATES = 4  # ray_like: GCS candidate nodes sampled per task
LEAF_GROUP = 32  # flux_like: nodes per leaf broker


def num_leaves(cfg: LaminarConfig) -> int:
    """The flux model's leaf brokers."""
    return max(1, cfg.num_nodes // LEAF_GROUP)


class BaselineDraws(NamedTuple):
    # workload.sample_arrivals: the engine's arrival fields (core.draws.Draws)
    arr_n: torch.Tensor  # () int32 Poisson(lam_t) arrival count (before the cap)
    arr_l: torch.Tensor  # (n_max,) uniform: L-task if >= f_share
    arr_squat: torch.Tensor  # (n_max,) uniform: squatter if < squatter_ratio
    arr_tier: torch.Tensor  # (n_max,) int32 tier code drawn from tier_probs
    arr_mass_f: torch.Tensor  # (n_max,) f32 F-task mass drawn from f_masses
    arr_mass_l: torch.Tensor  # (n_max,) f32 L-task mass drawn from l_masses
    arr_pri_f: torch.Tensor  # (n_max,) f32 F-task priority
    arr_pri_l: torch.Tensor  # (n_max,) f32 L-task priority
    arr_svc_exp: torch.Tensor  # (n_max,) standard exponential (F service)
    arr_svc_norm: torch.Tensor  # (n_max,) standard normal (L service)
    arr_pull_exp: torch.Tensor  # (n_max,) standard exponential (pull)
    # ray_like
    local_node: Optional[torch.Tensor] = None  # (C,) int32 uniform in [0, N): arrival's node
    shard_u: Optional[torch.Tensor] = None  # (C,) uniform: hot GCS shard if < skew
    pick_node: Optional[torch.Tensor] = None  # (C, 4) int32 uniform in [0, N): GCS candidates
    # flux_like
    leaf_gumbel: Optional[torch.Tensor] = None  # (C, n_leaves) standard Gumbel
    leaf_off: Optional[torch.Tensor] = None  # (C,) int32 uniform in [0, 32): node in leaf
    # workloads.disruption_step, when the scenario's disruption is on
    dis_u: Optional[torch.Tensor] = None  # () uniform: event if < fail_event_prob
    dis_start: Optional[torch.Tensor] = None  # () int32 first node of the block

    def to(self, device) -> "BaselineDraws":
        return BaselineDraws(*(None if x is None else x.to(device) for x in self))


class TorchBaselineDraws(TorchDraws):
    """One ``BaselineDraws`` per tick for ``model``, sampled from a
    ``torch.Generator`` (the engine provider's sampling and arrival-rate
    schedule). ``generator_device`` is where the generator lives (default:
    ``device``); two providers built with the same seed and
    ``generator_device="cpu"`` hand identical values to a CPU and a CUDA
    run. ``tick(t)`` takes an int or an int32 device tensor, as the engine
    provider's does."""

    def __init__(self, model: str, cfg: LaminarConfig, lam_per_tick: float, capacity: int,
                 seed: int, device, generator_device=None):
        if model not in MODELS:
            raise ValueError(f"unknown baseline model {model!r}")
        super().__init__(cfg, lam_per_tick, num_zones=1, seed=seed, device=device,
                         generator_device=generator_device)
        self.model = model
        self.capacity = capacity

    def signature(self) -> tuple:
        return super().signature() + (self.model, self.capacity)

    def _randint(self, gen, high: int, *shape):
        return torch.randint(0, high, shape, generator=gen, device=self.gdev,
                             dtype=torch.int32)

    def draw(self, t: torch.Tensor, gen: torch.Generator, tab: DrawTables) -> BaselineDraws:
        """Tick ``t``'s draws (an int32 tensor) from ``gen`` and ``tab``."""
        cfg = self.cfg
        N, C = cfg.num_nodes, self.capacity
        d = BaselineDraws(**self._arrivals(t, gen, tab))
        if self.model == "ray":
            d = d._replace(local_node=self._randint(gen, N, C), shard_u=self._u(gen, C),
                           pick_node=self._randint(gen, N, C, RAY_CANDIDATES))
        elif self.model == "flux":
            tiny = torch.finfo(torch.float32).tiny
            u = torch.clamp(self._u(gen, C, num_leaves(cfg)), min=tiny)
            d = d._replace(leaf_gumbel=-torch.log(-torch.log(u)),
                           leaf_off=self._randint(gen, LEAF_GROUP, C))
        if self.scenario.disruption.enabled:
            d = d._replace(dis_u=self._u(gen), dis_start=self._randint(gen, N))
        if self.gdev != self.device:
            d = d.to(self.device)
        return d


class ArrayBaselineDraws:
    """``BaselineDraws`` recorded beforehand: ``arrays`` maps each field to a
    numpy array whose leading axis is the tick (absent optional fields left
    out). ``model``, ``scenario`` and ``capacity`` say what they were made
    for."""

    def __init__(self, arrays: Dict[str, np.ndarray], model: str, scenario, capacity: int,
                 device="cpu"):
        self.arrays = arrays
        self.model = model
        self.scenario = scenario
        self.capacity = capacity
        self.device = torch.device(device)

    def tick(self, t: int) -> BaselineDraws:
        return BaselineDraws(
            **{k: torch.from_numpy(np.array(v[t])) for k, v in self.arrays.items()}
        ).to(self.device)
