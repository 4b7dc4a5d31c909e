"""Quick dev smoke of the PyTorch port: a tiny Laminar run, prints the summary.

    PYTHONPATH=src python scripts/torch_smoke_engine.py               # the CUDA card
    PYTHONPATH=src python scripts/torch_smoke_engine.py --device cpu  # plain PyTorch

The counterpart of ``scripts/smoke_engine.py``: the same config, two runs on
one engine (seeds 0 and 1) and the same lines. On the card the first run
includes the capture of its tick as a CUDA graph (the reference's jit
compile); the second replays it.
"""
import argparse
import time

from repro_torch.core import LaminarConfig, LaminarEngine

CFG = LaminarConfig(
    num_nodes=128,
    zone_size=32,
    probe_capacity=2048,
    max_arrivals_per_tick=128,
    horizon_ms=500.0,
    rho=0.8,
)
FIELDS = (
    "arrived",
    "started",
    "completed",
    "fastfail",
    "lost",
    "timeout",
    "reserve_expired",
    "infeasible_winner",
    "start_success_ratio",
    "p50_ms",
    "p99_ms",
    "control_us_per_start",
    "lambda_per_s",
)


def report(out, first_s: float, second_s: float) -> str:
    """What ``scripts/smoke_engine.py`` prints for the first run's summary
    ``out`` and the two runs' seconds."""
    return "\n".join([
        f"first run (incl compile): {first_s:.1f}s; second run: {second_s:.1f}s",
        *(f"{k:>24}: {out[k]}" for k in FIELDS),
        f"wall: {first_s:.1f}s",
    ])


def main(argv=None):
    """Both runs; returns their summaries and seconds."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    eng = LaminarEngine(CFG, device=args.device)
    t0 = time.time()
    out = eng.run(seed=0)
    t1 = time.time()
    out2 = eng.run(seed=1)
    t2 = time.time()
    print(report(out, t1 - t0, t2 - t1))
    return {"runs": [out, out2], "seconds": [t1 - t0, t2 - t1]}


if __name__ == "__main__":
    main()
