"""Quickstart on PyTorch: run the Laminar cluster engine and read its vitals.

    PYTHONPATH=src python examples/torch_quickstart.py               # the CUDA card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu  # plain PyTorch

The counterpart of ``examples/quickstart.py`` on ``repro_torch``: the same
cluster, the same run and the same six lines. A 256-node post-landing
cluster (rigid-topology jobs pre-painted into the node bitmaps) takes a
bimodal open-loop stream at rho = 0.8: F-tasks probe, bounce, reserve and
start in a few ms of simulated time with near-O(1) control work per
success. On the card the run is captured once as a CUDA graph and
replayed; its tick launches the hand-written ``bitmap_fit_rounds``,
``utility_topk_address`` and ``zone_aggregate_members`` (memory is off, so
no ``survival_scan``). Without a card it raises unless given
``--device cpu``.
"""

import argparse

from repro_torch.core import LaminarConfig, LaminarEngine

CFG = LaminarConfig(
    num_nodes=256,
    zone_size=64,
    probe_capacity=4096,
    max_arrivals_per_tick=256,
    horizon_ms=1000.0,
    rho=0.8,
)


def report(cfg, out) -> str:
    """The six lines ``examples/quickstart.py`` prints for the summary ``out``."""
    return "\n".join([
        f"cluster: {cfg.num_nodes} nodes x {cfg.atoms_per_node} atoms, "
        f"{cfg.num_zones} zones; lambda = {out['lambda_per_s']:.0f} tasks/s",
        f"arrived            : {out['arrived']}",
        f"started            : {out['started']}  "
        f"(success ratio {out['start_success_ratio']:.4f})",
        f"latency p50 / p99  : {out['p50_ms']:.2f} ms / {out['p99_ms']:.2f} ms",
        f"control work/start : {out['control_us_per_start']:.4f} us  (~O(1))",
        f"probe dissipation  : fastfail={out['fastfail']} lost={out['lost']} "
        f"expired={out['reserve_expired']}",
    ])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    out = LaminarEngine(CFG, device=args.device).run(seed=0)
    print(report(CFG, out))
    return out


if __name__ == "__main__":
    main()
