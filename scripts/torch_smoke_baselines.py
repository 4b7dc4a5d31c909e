"""Dev smoke of the PyTorch port's three baselines on a small cluster.

    PYTHONPATH=src python scripts/torch_smoke_baselines.py               # the CUDA card
    PYTHONPATH=src python scripts/torch_smoke_baselines.py --device cpu  # plain PyTorch

The counterpart of ``scripts/smoke_baselines.py``: the same config and
capacity, one run a baseline (``core.baselines.RUNNERS``) and the same line
for each. On the card each run captures its tick as a CUDA graph and
replays it; the baselines run no hand-written kernel.
"""
import argparse
import time

from repro_torch.core import LaminarConfig
from repro_torch.core.baselines import RUNNERS

CFG = LaminarConfig(
    num_nodes=256,
    zone_size=64,
    probe_capacity=4096,
    max_arrivals_per_tick=256,
    horizon_ms=500.0,
    rho=0.8,
)
CAPACITY = 1 << 15


def report(name: str, out, wall_s: float) -> str:
    """The line ``scripts/smoke_baselines.py`` prints for baseline ``name``."""
    return (
        f"{name:>6}: arrived={out['arrived']} started={out['started']} "
        f"success={out['start_success_raw']:.3f} p50={out['p50_ms']:.2f}ms "
        f"p99={out['p99_ms']:.1f}ms lam={out['lambda_per_s']:.0f}/s wall={wall_s:.1f}s"
    )


def main(argv=None):
    """One run a baseline; returns their summaries by name."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    outs = {}
    for name, run in RUNNERS.items():
        t0 = time.time()
        outs[name] = run(CFG, seed=0, capacity=CAPACITY, device=args.device)
        print(report(name, outs[name], time.time() - t0))
    return outs


if __name__ == "__main__":
    main()
