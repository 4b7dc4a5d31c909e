"""The control of the benchmark's correctness check: the plain reference in a
lower precision, put in the program's place, has to come out not correct.

    python3 portbench/control.py --workload CELL --seeds N [N ...]

The configuration states float32; the control is the reference with every
float32 field of the state rounded through bfloat16 after each tick
(:class:`ControlProgram`), run as a cell runs: the traffic's warm-up, one
window segment, the same check (``benchlib.check.check_run``) against the
reference in full precision. Prints one JSON line a seed with the numbers
compared. On a CUDA card by default (the cell's own size); ``--device
cpu`` for small configurations. The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


class ControlProgram:
    """Stands where ``benchlib.program.Program`` stands: the reference, seed
    by seed, each tick's float32 fields rounded through ``round_to``."""

    def __init__(self, cell, seed: int, device, round_to=None):
        import torch

        from benchlib import check

        self.device = torch.device(device)
        self.seeds = [seed + i for i in range(int(cell.traffic["seeds"]))]
        self.lockstep = True  # states are per-seed lists
        self.seg = int(cell.traffic["segment_ticks"])
        self.round_to = torch.bfloat16 if round_to is None else round_to
        self.ref = check.Reference(cell, self.seeds, self.device)
        self.cfg = self.ref.cfg
        self.init_state = [self.ref.init_state] * len(self.seeds)
        self.state = self.init_state
        self.tick = 0
        self.engine = None

    def segment(self):
        start, t0 = self.state, self.tick
        outs = [self.ref.follow(s, i, t0, self.seg, self.round_to) for i, s in enumerate(start)]
        self.state = [s for s, _ in outs]
        self.tick += self.seg
        return start, self.state, [ts for _, ts in outs], t0

    def seed_state(self, s, i: int):
        return s[i]

    def seed_series(self, ts, i: int):
        return ts[i]

    def summarize(self, s, ts) -> dict:
        return self.ref.summarize(s, ts)


def control_run(cell, seed: int, device) -> dict:
    """The control's numbers compared for one seed of ``cell``."""
    import torch

    from benchlib import check, program

    dev = torch.device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    prog = ControlProgram(cell, seed, dev)
    first = program.warm_up(prog, int(cell.traffic["warmup_ticks"]), sync)
    sample = program.Sample(seed)
    win = program.window(prog, 0.0, sample, sync)
    ref = check.Reference(cell, prog.seeds, dev)
    res = check.check_run(prog, ref, first, sample.kept, win["last"], seed)
    return {"seed": seed, "numbers": {k: v["value"] for k, v in res["numbers"].items()},
            "correct": all(v["value"] <= v["limit"] for v in res["numbers"].values()),
            "reference_s": res["seconds"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(HERE), str(HERE.parent / "src")]
    import torch

    from benchlib import spec

    if args.device == "cuda" and not torch.cuda.is_available():
        print("control: CUDA is not available", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = control_run(cell, seed, args.device)
        out["seconds"] = time.perf_counter() - t0
        out["workload"] = cell.name
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
