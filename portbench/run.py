"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload CELL --seed N --seconds S --trace 0|1

From the root of a checkout of the repository, on a machine with an NVIDIA
card. Set-up: the cell's files (``BENCHMARK.json``, ``configs/``,
``traffic/``), the port's kernels (built into ``build/kernels/`` on a
checkout's first run, loaded after), the initial state on the card from
the seed, the capture of the tick and the traffic's warm-up ticks. Then
the window: segments of the compiled engine (``benchlib.program``) for
``--seconds`` of wall time, closed at a segment boundary. ``--trace 1``
then profiles one more segment for the per-layer metrics
(``metrics/<name>.py``). Last, the plain reference (``reference/``) checks
the run (``benchlib.check``).

The last line of standard output is one JSON object: ``correct``,
``attempted`` (seed-segments of the window), ``failed`` (checked
seed-segments that differ from the reference), ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``, every number
compared beside its limit (also the last lines of standard error). Exits
non-zero, with no result, without a card, without the port's sources, or
when the process holds JAX or the JAX package.
"""

import time

T_START = time.perf_counter()


def _age() -> float:
    """Seconds since this process started, at ``T_START`` (0 where ``/proc``
    does not say)."""
    import os

    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19]) / os.sysconf("SC_CLK_TCK")
        with open("/proc/uptime") as f:
            return max(0.0, float(f.read().split()[0]) - start - (time.perf_counter() - T_START))
    except (OSError, ValueError, IndexError):
        return 0.0

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # top-level module names, compared whole


def _environment() -> None:
    """Caches inside the checkout, at fixed paths; the port's sources and
    this folder importable."""
    cache = CHECKOUT / "build" / "portbench"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    for p in (str(HERE), str(CHECKOUT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def fail(msg: str, code: int = 2) -> int:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    return code


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()

    import torch

    from benchlib import spec

    try:
        cell = spec.load_cell(args.workload)
    except (OSError, KeyError, ValueError) as e:
        return fail(f"cannot load workload {args.workload!r}: {e}")
    if not torch.cuda.is_available():
        return fail("CUDA is not available: this benchmark measures the card, never the CPU")
    if torch.cuda.device_count() < cell.chips:
        return fail(f"{cell.name} needs {cell.chips} cards, {torch.cuda.device_count()} visible")
    if not (CHECKOUT / "src" / "repro_torch").is_dir():
        return fail(f"the port's sources are not at {CHECKOUT / 'src' / 'repro_torch'}")
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START - _age())
    found = forbidden_modules()
    if found:
        return fail(f"the process holds {found} once the window has closed")
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
             program=None) -> dict:
    """One run of ``cell`` on ``device``: its result line as a dict.
    ``program`` builds the system under test (default
    ``benchlib.program.Program``); tests hand in a broken one."""
    import torch

    from benchlib import check, program as prog_mod

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    if cuda:
        from repro_torch.kernels import _build

        torch.cuda.set_device(dev)
        _build.build()
    prog = (program or prog_mod.Program)(cell, seed, dev)
    first = prog_mod.warm_up(prog, int(cell.traffic["warmup_ticks"]), sync)
    setup_s = time.perf_counter() - t_start

    sample = prog_mod.Sample(seed)
    win = prog_mod.window(prog, seconds, sample, sync)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    end_to_end = {
        "sim_ticks_per_s": {"value": win["seed_ticks"] / win["wall_s"], "unit": "ticks/s"},
        "setup_s": {"value": setup_s, "unit": "s"},
    }
    out = {"correct": None, "attempted": win["segments"] * len(prog.seeds), "failed": None,
           "metrics": {m.name: end_to_end[m.name] for m in cell.end_to_end}}
    out["device"] = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "count": cell.chips,
        "memory_peak_bytes": int(peak),
    }
    if trace:
        out["metrics"], busy_window, out["breakdown"] = _traced(cell, prog, sync)
        out["device"].update(busy_window)

    prog.engine = None  # the compiled ticks go; the states the check reads stay
    if cuda:
        torch.cuda.empty_cache()
    ref = check.Reference(cell, prog.seeds, dev)
    res = check.check_run(prog, ref, first, sample.kept, win["last"], seed)
    numbers = res["numbers"]
    out["correct"] = all(c["value"] <= c["limit"] for c in numbers.values())
    out["failed"] = res["failed"]
    out["checks"] = numbers  # the numbers compared, the result's last key
    print(f"portbench: the reference took {res['seconds']:.3f} s; mismatched fields "
          f"{json.dumps(res['detail'])}", file=sys.stderr, flush=True)
    return out


def _traced(cell, prog, sync):
    """One segment's host enqueue time, then one more segment under
    ``torch.profiler``: the cell's per-layer metrics, the device's busy and
    traced seconds, and the breakdown."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchlib import roofline, spec, trace as trace_mod
    from reference.draws import max_dispatch

    t0 = time.perf_counter()
    prog.segment()  # its host enqueue, the profiler off (it slows each launch)
    enqueue = time.perf_counter() - t0
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prog.segment()
        sync()
        wall = time.perf_counter() - t0
    s0 = prog.seed_state(prog.state, 0)
    B = len(prog.seeds) if prog.lockstep else 1
    zones = s0.zstart.shape[0]
    tr = trace_mod.from_profiler(
        prof, replays=prog.seg, seeds=len(prog.seeds), wall_s=wall, enqueue_s=enqueue,
        entry_bytes=roofline.entry_bytes(prog.cfg, s0, B),
        tick_bytes=roofline.tick_bytes(prog.cfg, s0, zones, max_dispatch(prog.cfg), 11, B),
        peak_bytes_per_s=roofline.HBM_BYTES_PER_S)
    metrics = {}
    for m in cell.per_layer:
        v = spec.reader(m.name, cell.root)(tr)
        if v is not None:
            metrics[m.name] = {"value": v, "unit": m.unit}
    busy = tr.busy_s()
    return metrics, {"busy_s": busy if busy is not None else 0.0, "window_s": wall}, \
        tr.breakdown()


if __name__ == "__main__":
    sys.exit(main())
