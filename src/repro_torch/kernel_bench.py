"""Device time of ``survival_scan`` on the card, by launch, and against an
earlier design built from another source.

    python -m repro_torch.kernel_bench [--parent PATH] [--phases] [--out FILE]

At the survival_scan shapes of ``chip_smoke.py`` phase 2 (Exp5: 5000 nodes,
65 536 probe slots; Exp7's top cell: 65 536 nodes, 131 072 slots), Airlock
on and off, with the inputs phase 2 draws (seeded numpy):

  * the port's kernel through its wrapper's launch function and plan: device
    ms of one call, as ``chip_smoke.py`` times it (20 calls captured in a CUDA
    graph and replayed, median of 5 replays; inputs warm in L2), and the
    device time of each of its kernels (``torch.profiler`` over 50 eager
    calls: the sum of each kernel's own device durations per call);
  * with ``--parent PATH``, the earlier nine-launch design
    (``survival_scan.cu`` of that age, whose launcher takes nine grids and
    blocks and eight scratch offsets) built from PATH with the port's nvcc
    flags, checked equal to the port's outputs, timed the same way, in the
    order parent, port, port, parent;
  * with ``--phases``, the port's source built again with
    ``-DSURVIVAL_SCAN_PHASES``: the SM cycles each phase of the cluster
    kernel takes (the most over its 16 CTAs), between the stamps thread 0 of
    each CTA takes at the ends of the phases and around each cluster
    barrier; and the graph-replay ms of that build.

Prints one line per measurement, the card's name and power limit, and writes
the numbers as JSON to ``--out`` (default ``build/kernel_bench.json``).
Needs a CUDA card and ``nvcc``; exits non-zero without them.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.launch_plan import cdiv
from repro_torch.kernels.survival_scan import ops as surv_ops
from repro_torch.kernels.survival_scan import plan as surv_plan

GEOMETRIES = {"Exp5": (5000, 65536), "Exp7": (65536, 131072)}  # (N, P)
KW = dict(residual=0.3, watermark=0.9, safe=0.8, t_susp=80, t_surv=240)
PARENT_THREADS, PARENT_SCAN_THREADS = 256, 1024  # kThreads, kScanThreads of that source


def inputs(N: int, P: int, seed: int, dev):
    """The survival_scan case of ``chip_smoke.py``'s ``kernel_cases``."""
    rng = np.random.default_rng(seed)
    st = rng.choice([0, 4, 6, 7], size=P, p=[0.3, 0.1, 0.5, 0.1]).astype(np.int32)
    cols = (
        st, np.where(st != 0, rng.integers(0, N, P), -1).astype(np.int32),
        rng.uniform(0, 0.1, P).astype(np.float32),
        rng.choice([24.0, 48.0, 96.0, 256.0], P).astype(np.float32),
        rng.integers(0, 3, P).astype(np.int32), rng.uniform(size=P) < 0.1,
        rng.integers(0, 300, P).astype(np.int32), rng.integers(100, 600, P).astype(np.int32),
        rng.uniform(0.2, 0.8, N).astype(np.float32),
    )
    return tuple(torch.from_numpy(c).to(dev) for c in cols) + (
        torch.tensor(300, dtype=torch.int32, device=dev),)


def edge_cases(seed: int = 0) -> dict:
    """survival_scan inputs (CPU tensors) that stress the one-cluster
    design's corners, by name: scores tied at -0.0 / +0.0 (``ev`` and
    ``mem`` both signed zeros, every node over the watermark), scores of
    +-inf, one node holding a fifth of all slots, an all-empty table, every
    slot on one node, and Exp7's top-cell shape."""
    rng = np.random.default_rng(seed)
    out = {}

    def table(N, P):
        st = rng.choice([0, 4, 6, 7], size=P, p=[0.3, 0.1, 0.5, 0.1]).astype(np.int32)
        return dict(
            st=st, node=np.where(st != 0, rng.integers(0, N, P), -1).astype(np.int32),
            mem=rng.uniform(0, 0.1, P).astype(np.float32),
            ev=rng.choice([24.0, 48.0, 96.0, 256.0], P).astype(np.float32),
            tier=rng.integers(0, 3, P).astype(np.int32), mig=rng.uniform(size=P) < 0.1,
            stick=rng.integers(0, 300, P).astype(np.int32),
            sdl=rng.integers(100, 600, P).astype(np.int32),
            base=rng.uniform(0.2, 0.8, N).astype(np.float32))

    c = table(64, 4096)  # every slot resident, every node over the watermark
    c.update(st=np.full(4096, 6, np.int32), node=rng.integers(0, 64, 4096).astype(np.int32),
             tier=np.ones(4096, np.int32), base=np.full(64, 1.5, np.float32))
    c["ev"] = np.where(rng.uniform(size=4096) < 0.5, 0.0, -0.0).astype(np.float32)
    c["mem"] = np.where(rng.uniform(size=4096) < 0.5, 0.0, -0.0).astype(np.float32)
    out["zero_ties"] = c
    c = table(64, 4096)
    c.update(base=np.full(64, 1.5, np.float32))
    c["ev"] = rng.choice(np.array([np.inf, -np.inf, 24.0, 48.0], np.float32), 4096)
    c["mem"] = rng.choice(np.array([np.inf, 0.05, 0.01], np.float32), 4096)
    out["inf_scores"] = c
    c = table(5000, 65536)
    c["node"][rng.permutation(65536)[: 65536 // 5]] = 17
    out["fifth_on_one"] = c
    c = table(5000, 65536)
    c.update(st=np.zeros(65536, np.int32), node=np.full(65536, -1, np.int32),
             mig=np.zeros(65536, bool))
    out["all_empty"] = c
    c = table(5000, 65536)
    c["node"][:] = 3
    out["all_on_one"] = c
    out["exp7"] = table(65536, 131072)
    keys = ("st", "node", "mem", "ev", "tier", "mig", "stick", "sdl", "base")
    return {name: tuple(torch.from_numpy(np.ascontiguousarray(c[k])) for k in keys)
            + (torch.tensor(300, dtype=torch.int32),) for name, c in out.items()}


def graph_ms(fn, reps=20, rounds=5) -> float:
    """Device ms of one call: ``reps`` calls in one CUDA graph, replayed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / reps)
    return float(np.median(out))


def per_kernel_ms(fn, calls=50) -> dict:
    """Device ms per call of each kernel ``fn`` launches (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us > 0 and ev.count >= calls:
            out[ev.key] = dev_us / 1e3 / calls
    return out


PHASES = ("read, count, scan over warps, push counts", "barrier 1", "offsets, place entries",
          "barrier 2", "fold, victim keys, mask words", "barrier 3", "masks")


def build_lib(path: Path, name: str, *flags: str) -> ctypes.CDLL:
    """``path`` built with the port's nvcc flags (and ``flags``) into
    ``build/<name>/``, loaded."""
    out_dir = _build.BUILD_DIR.parent / name
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f"{name}.so"
    cmd = [_build.nvcc(), *_build.NVCC_FLAGS, *flags, "-o", str(lib), str(path)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {path}:\n{res.stdout}{res.stderr}")
    return ctypes.CDLL(str(lib))


class Phases:
    """The port's kernel with phase stamps (``-DSURVIVAL_SCAN_PHASES``)."""

    def __init__(self):
        self.lib = build_lib(_build.CSRC / "survival_scan.cu", "phases", "-DSURVIVAL_SCAN_PHASES")
        for fn, argtypes in surv_ops._SIG.items():
            getattr(self.lib, fn).argtypes = argtypes
        self.lib.survival_scan_phases.argtypes = [ctypes.c_void_p]

    def call(self, args, airlock: bool):
        kw = dict(KW, airlock=airlock)
        plan = surv_plan.for_call(*args, **kw)
        outs = plan.new_outputs(args[0].device)
        scratch = torch.empty(plan.scratch_words, dtype=torch.int32, device=args[0].device)
        err = self.lib.survival_scan_launch(
            *(_build.ptr(x) for x in (*args, *outs, scratch)), args[0].shape[0],
            args[8].shape[0], int(airlock), KW["residual"], KW["watermark"], KW["safe"],
            KW["t_susp"], KW["t_surv"], *surv_plan.pack(plan), plan.scratch_words,
            _build.stream(args[0]))
        _build.check(err, "survival_scan (phases)")
        return outs

    def cycles(self, args, airlock: bool) -> list:
        """The most SM cycles any CTA spent in each phase of one call."""
        self.call(args, airlock)
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * (16 * 8))()
        _build.check(self.lib.survival_scan_phases(buf), "survival_scan_phases")
        stamps = np.array(list(buf), dtype=np.int64).reshape(16, 8)
        return [int(x) for x in np.diff(stamps, axis=1).max(axis=0)]


class Parent:
    """The earlier nine-launch design, built from ``path``."""

    def __init__(self, path: Path):
        self.lib = build_lib(path, "parent")
        P_, I_, F_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        self.lib.survival_scan_launch.argtypes = (
            [P_] * 16 + [I_, I_, I_, F_, F_, F_, I_, I_, P_, P_, P_, I_, P_])
        self.lib.survival_scan_launch.restype = I_

    def call(self, args, airlock: bool):
        st, base = args[0], args[8]
        P, N = st.shape[0], base.shape[0]
        dev = st.device
        outs = [torch.empty(N, dtype=torch.float32, device=dev)] + [
            torch.empty(P, dtype=torch.bool, device=dev) for _ in range(4)]
        words = 6 * N + 1 + 2 * P
        scratch = torch.empty(words, dtype=torch.int32, device=dev)
        nb, pb = cdiv(N, PARENT_THREADS), cdiv(P, PARENT_THREADS)
        grids = (ctypes.c_int * 9)(nb, pb, 1, pb, nb, pb if airlock else 0, pb, pb, pb)
        blocks = (ctypes.c_int * 9)(*([PARENT_THREADS] * 2 + [PARENT_SCAN_THREADS]
                                      + [PARENT_THREADS] * 6))
        carve = (ctypes.c_int * 8)(0, N, 2 * N, 3 * N + 1, 4 * N + 1, 5 * N + 1, 6 * N + 1,
                                   6 * N + 1 + P)
        err = self.lib.survival_scan_launch(
            *(_build.ptr(x) for x in (*args, *outs, scratch)), P, N, int(airlock),
            KW["residual"], KW["watermark"], KW["safe"], KW["t_susp"], KW["t_surv"],
            grids, blocks, carve, words, _build.stream(st))
        _build.check(err, "survival_scan (parent)")
        return outs


def port_call(args, airlock: bool):
    kw = dict(KW, airlock=airlock)
    plan = surv_plan.for_call(*args, **kw)
    outs = plan.new_outputs(args[0].device)
    surv_ops.launch(plan, outs, *args, **kw)
    return outs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, help="survival_scan.cu of the nine-launch design")
    ap.add_argument("--phases", action="store_true",
                    help="cycles by phase of the cluster kernel (an instrumented build)")
    ap.add_argument("--out", type=Path, default=Path("build/kernel_bench.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_bench: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    _build.build(["survival_scan"])
    parent = Parent(args.parent) if args.parent else None
    phases = Phases() if args.phases else None
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi unavailable"
    rows = []
    for seed, (label, (N, P)) in enumerate(GEOMETRIES.items(), start=2):
        a = inputs(N, P, seed, dev)
        for airlock in (True, False):
            tag = f"{label} N={N} P={P} {'airlock' if airlock else 'kernel-oom'}"
            row = dict(geometry=label, N=N, P=P, airlock=airlock)
            designs = [("port", lambda: port_call(a, airlock))]
            if parent is not None:
                designs.append(("parent", lambda: parent.call(a, airlock)))
                want, got = parent.call(a, airlock), port_call(a, airlock)
                differ = {o: int((x != y).sum()) for o, x, y in
                          zip(("pressure", "victim", "resume", "react", "expire"), want, got)
                          if not torch.equal(x, y)}
                same = not differ
                row["equal_to_parent"] = same
                print(f"{tag}: " + ("port == parent on every output" if same else
                                    f"port and parent differ, entries per output: {differ}"))
                if not same:
                    return 1
            for name, fn in designs:
                row[f"{name}_kernels_ms"] = k = per_kernel_ms(fn)
                print(f"{tag}: {name} per-kernel device ms per call (profiler, eager): "
                      + ", ".join(f"{kk} {v:.6f}" for kk, v in k.items())
                      + f"; sum {sum(k.values()):.6f}")
            order = ["parent", "port", "port", "parent"] if parent is not None else ["port"]
            fns = dict(designs)
            times = [(name, graph_ms(fns[name])) for name in order]
            row["graph_ms"] = times
            print(f"{tag}: graph-replay device ms per call, in order: "
                  + ", ".join(f"{n} {t:.6f}" for n, t in times))
            if phases is not None:
                row["phase_cycles"] = c = dict(zip(PHASES, phases.cycles(a, airlock)))
                row["phases_build_ms"] = graph_ms(lambda: phases.call(a, airlock))
                print(f"{tag}: SM cycles by phase (most over the CTAs; instrumented build, "
                      f"{row['phases_build_ms']:.6f} ms a call): "
                      + ", ".join(f"{k} {v}" for k, v in c.items()) + f"; sum {sum(c.values())}")
            rows.append(row)
    print(card)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"card": card, "torch": torch.__version__,
                                    "cuda": torch.version.cuda, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
