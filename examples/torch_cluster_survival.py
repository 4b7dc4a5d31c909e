"""Airlock in action on PyTorch: the same overloaded cluster with and without
the runtime-survival layer (the paper's Exp5 in miniature).

    PYTHONPATH=src python examples/torch_cluster_survival.py               # the CUDA card
    PYTHONPATH=src python examples/torch_cluster_survival.py --device cpu  # plain PyTorch

The counterpart of ``examples/cluster_survival.py`` on ``repro_torch``: the
same cluster, the same two runs and the same two lines. Without Airlock,
kernel-style OOM destroys the largest residents (L-tasks). With Airlock,
pressure converts into priority-ordered suspension, in-situ recovery,
bounded secondary re-addressing, or bounded reclamation, and L-task OOM
kills go to zero. Memory is on, so on the card each run's captured tick
launches all four hand-written tick kernels, ``survival_scan`` included.
Without a card it raises unless given ``--device cpu``.
"""

import argparse
import dataclasses

from repro_torch.core import LaminarConfig, LaminarEngine, MemoryConfig

BASE = LaminarConfig(
    num_nodes=256,
    zone_size=64,
    probe_capacity=4096,
    max_arrivals_per_tick=256,
    horizon_ms=1200.0,
    rho=0.75,
    two_phase=False,
    regeneration=False,
    hop_loss=0.0,
    memory=MemoryConfig(enabled=True),
)


def report(cfg, out) -> str:
    """The line ``examples/cluster_survival.py`` prints for the run of
    ``cfg`` (Airlock off or on) and its summary ``out``."""
    tag = "airlock ON " if cfg.airlock else "airlock OFF"
    return (
        f"[{tag}] completed={out['completed_success_ratio']:.4f} "
        f"L-task OOM kills={out['oom_kill_l']} "
        f"exec survival={out['exec_survival_ratio']:.4f} "
        f"suspended={out['suspended_cnt']} resumed={out['resumed_insitu']} "
        f"migrated={out['migrated']} reclaimed={out['reclaimed']} "
        f"probe_drops={out['probe_drops']}"
    )


def main(argv=None):
    """Both runs, Airlock off then on; returns their summaries in that order."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    outs = []
    for airlock in (False, True):
        cfg = dataclasses.replace(BASE, airlock=airlock)
        outs.append(LaminarEngine(cfg, device=args.device).run(seed=0))
        print(report(cfg, outs[-1]))
    return outs


if __name__ == "__main__":
    main()
