"""Serving driver: ``python -m repro_torch.launch.serve --arch <id> [--smoke]``.

Runs the Laminar serving engine end to end on one device (the CUDA card
unless ``--device cpu``): requests with declared priorities are admitted
probe-first onto replica page pools, prefilled (two-phase payload pull) and
batch-decoded; under KV pressure the Airlock ladder suspends / resumes /
re-addresses / reclaims in priority order. A port of
``repro.launch.serve``'s loop, kept as it is: each tick, each replica
decodes its running requests from a fresh cache of ``S_MAX`` slots at the
first request's prompt length, and the model does not run at prefill
(``on_prefill_done`` only).

The decode step is compiled, as the reference jits it
(``repro/launch/serve.py:40``): :class:`CompiledDecode` keeps one body a
batch size over static buffers (the tokens, the position as a 0-d int32 on
the device, a fresh cache of ``S_MAX`` slots). On CUDA each body is captured
once as a CUDA graph and replayed, at most ``ServeConfig.max_slots`` graphs
for both replicas and every tick; on the CPU the same body runs as it is.
"""

from __future__ import annotations

import argparse
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

S_MAX = 96


class CompiledDecode:
    """``lm.decode_step`` from a fresh cache of ``s_max`` slots, compiled
    once a batch size: the reference's ``jax.jit(lambda p, t, i, c:
    lm.decode_step(cfg, p, t, i, c))`` with ``c = lm.init_cache(cfg, B,
    s_max)``.

    A call copies the (B, 1) int32 tokens and the position (a host int,
    filled on the device with no sync) into batch size B's static buffers
    and runs its body, which leaves the logits (B, 1, V) in a static output:
    the tensor returned, overwritten by B's next call. On CUDA the body is
    captured as a CUDA graph at B's first call (warm-up and capture on one
    side stream a device, ``capture_error_mode="thread_local"``; the graph is
    kept, so ``kernel_bench.graph_census`` can read its nodes) and replayed;
    a capture that fails raises. On the CPU the body runs. The body never
    writes the static cache (``decode_step`` writes a copy), so every call
    decodes from a fresh cache, zeros with ``pos = arange``, as the
    reference's loop does. The parameters are read in place, never copied.
    """

    def __init__(self, cfg, params, s_max: int = S_MAX):
        self.cfg, self.params, self.s_max = cfg, params, s_max
        self.steps: Dict[int, _DecodeBody] = {}  # batch size -> its body (and graph)

    def __call__(self, tokens: torch.Tensor, position: int) -> torch.Tensor:
        B = tokens.shape[0]
        with torch.inference_mode():
            body = self.steps.get(B)
            if body is None:
                body = self.steps[B] = _DecodeBody(self.cfg, self.params, B, self.s_max,
                                                   tokens.device)
            return body(tokens, position)


class _DecodeBody:
    """Batch size B's static buffers, its body and, on CUDA, its graph."""

    def __init__(self, cfg, params, B: int, s_max: int, device):
        from repro_torch.core.scan import capture, on_side_stream
        from repro_torch.models import lm

        self.cfg, self.params = cfg, params
        self.tokens = torch.zeros((B, 1), dtype=torch.int32, device=device)
        self.position = torch.zeros((), dtype=torch.int32, device=device)
        self.cache = lm.init_cache(cfg, B, s_max, device)
        self.logits = None
        self.graph = None
        dev = self.tokens.device  # a tensor's device: cuda:<index>
        if dev.type == "cuda":
            on_side_stream(self._body, dev)  # warm-up: lazy initializations outside the capture
            self.graph = capture(self._body, dev)

    def _body(self) -> None:
        from repro_torch.models import lm

        self.logits, _ = lm.decode_step(self.cfg, self.params, self.tokens, self.position,
                                        self.cache)

    def __call__(self, tokens: torch.Tensor, position: int) -> torch.Tensor:
        self.tokens.copy_(tokens)
        self.position.fill_(int(position))
        if self.graph is None:
            self._body()
        else:
            self.graph.replay()
        return self.logits


class Served(NamedTuple):
    stats: Dict[str, int]  # the scheduler's counters
    emitted: Dict[int, List[int]]  # each request's decoded tokens
    requests: Dict[int, object]  # the scheduler's ``Request`` records


def default_prompt(rid: int, length: int, vocab: int) -> torch.Tensor:
    """Request ``rid``'s prompt: (1, length) tokens from a CPU generator
    seeded with ``rid``, the same on every device."""
    g = torch.Generator().manual_seed(rid)
    return torch.randint(0, vocab, (1, length), generator=g, dtype=torch.int32)


def serve(
    cfg,
    params,
    *,
    requests: int = 24,
    replicas: int = 2,
    ticks: int = 120,
    seed: int = 0,
    prompts: Optional[Callable[[int, int], object]] = None,
    device="cuda",
) -> Served:
    """Drive the serving scheduler and the model for ``ticks`` ticks.

    ``prompts(rid, length)`` gives request ``rid``'s (1, length) prompt
    (default: :func:`default_prompt`). Returns the scheduler's stats, each
    request's emitted tokens and the requests."""
    from repro_torch.core.engine import _resolve_device
    from repro_torch.sched.serving import LaminarServingScheduler, ServeConfig

    dev = _resolve_device(device)
    rng = np.random.default_rng(seed)
    scfg = ServeConfig(pages_per_replica=128, max_slots=4)
    sched = LaminarServingScheduler(scfg, num_replicas=replicas, seed=seed)
    if prompts is None:
        prompts = lambda rid, n: default_prompt(rid, n, cfg.vocab)  # noqa: E731

    decode = CompiledDecode(cfg, params)
    toks_of: Dict[int, torch.Tensor] = {}
    positions: Dict[int, int] = {}
    emitted: Dict[int, List[int]] = {}
    submitted = 0
    with torch.inference_mode():
        for _ in range(ticks):
            # open-loop arrivals with mixed priorities
            while submitted < requests and rng.uniform() < 0.5:
                pr = float(rng.choice([8.0, 32.0, 128.0]))
                rid = sched.submit(
                    prompt_len=int(rng.integers(4, 16)),
                    max_new=int(rng.integers(4, 12)), priority=pr,
                )
                toks_of[rid] = torch.tensor(
                    np.asarray(prompts(rid, sched.requests[rid].prompt_len)),
                    dtype=torch.int32, device=dev)
                emitted[rid] = []
                submitted += 1
            actions = sched.tick()
            for rid in actions["prefill"]:
                sched.on_prefill_done(rid)
                positions[rid] = toks_of[rid].shape[1]
            for ri in range(replicas):
                running = sched.running(ri)
                if not running:
                    continue
                toks = torch.cat(
                    [
                        toks_of[rid][:, -1:]
                        if not emitted[rid]
                        else torch.tensor([[emitted[rid][-1]]], dtype=torch.int32, device=dev)
                        for rid in running
                    ],
                    dim=0,
                )
                logits = decode(toks, positions[running[0]])
                nxt = torch.argmax(logits[:, 0], dim=-1).tolist()
                for j, rid in enumerate(running):
                    emitted[rid].append(int(nxt[j]))
                    sched.on_token(rid)
    return Served(dict(sched.stats), emitted, sched.requests)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--ticks", type=int, default=120)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    from repro_torch.configs import get, get_smoke
    from repro_torch.core.engine import _resolve_device
    from repro_torch.models import lm

    dev = _resolve_device(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get(args.arch)
    params = lm.init_params(cfg, args.seed, dev)
    s, emitted, reqs = serve(
        cfg, params, requests=args.requests, replicas=args.replicas, ticks=args.ticks,
        seed=args.seed, device=dev,
    )
    print(
        f"arch={cfg.name} replicas={args.replicas} arrived={s['arrived']} "
        f"started={s['started']} completed={s['completed']} "
        f"suspended={s['suspended']} resumed={s['resumed_insitu']} "
        f"migrated={s['migrated']} reclaimed={s['reclaimed']} "
        f"fastfail={s['fastfail']}"
    )
    done = [r for r in reqs.values() if r.state == "done"]
    for r in done[:5]:
        print(f"  rid={r.rid} prio={r.priority:.0f} tokens={emitted[r.rid]}")


if __name__ == "__main__":
    main()
