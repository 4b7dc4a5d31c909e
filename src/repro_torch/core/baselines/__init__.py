"""Optimistic architectural cost models of the three competing paradigms,
ported from ``repro.core.baselines``. ``RUNNERS[name](cfg, bcfg=None,
seed=0, capacity=..., num_ticks=None, device="cuda", draws=None)`` runs
one and returns its summary."""

from repro_torch.core.baselines import flux_like, ray_like, slurm_like

RUNNERS = {
    "slurm": slurm_like.run,
    "ray": ray_like.run,
    "flux": flux_like.run,
}

__all__ = ["slurm_like", "ray_like", "flux_like", "RUNNERS"]
