"""Decode after prefill against forward's last logits, in the JAX package
and in the PyTorch port, on the CPU, with the same parameters and tokens.

    PYTHONPATH=src python scripts/torch_decode_gap.py [--arch qwen3-1.7b] [--layers 2]
        [--seq 2048] [--smoke]
    PYTHONPATH=src python scripts/torch_decode_gap.py --port-only [--cuda] ...

Builds ``--arch`` at its full width (``--smoke``: the smoke width) cut to
``--layers`` layers (the layer pattern cut to as many kinds when it is
longer, as recurrentgemma-2b's one group of 26), bfloat16 compute (the
config's own), draws the
reference's parameters from seed 0 and carries them to the port, and for
each package runs ``forward`` over ``--seq`` tokens and ``prefill`` of the
first ``seq - 1`` plus one ``decode_step``: prints each package's gap
between decode's logits and forward's last logits (max abs, logit scale,
entries past rtol = atol = 0.05) and the two packages' logits against each
other. Needs several GiB of memory at full width; run it on its own.

``--port-only`` imports no JAX: the port's own parameters (seed 0, drawn on
the CPU) and its gap on the CPU; with ``--cuda`` the same parameters and
tokens on the card too, and the two devices' logits against each other.
That is how a depth the reference cannot run here (26 layers of
recurrentgemma-2b) is measured on a machine with a card and a large host.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import sys
import time
from pathlib import Path

import numpy as np
import torch

TOL = 0.05


def gap(dec, full):
    d = np.abs(dec - full)
    return float(d.max()), float(np.abs(full).max()), int((d > TOL + TOL * np.abs(full)).sum())


def cut(base, layers):
    pattern = base.pattern[:layers] if len(base.pattern) > layers else base.pattern
    return dataclasses.replace(base, n_layers=layers, pattern=pattern)


def port_run(tc, tp, tok, device):
    """The port's forward's last logits and its decode after prefill, as
    float32 numpy, and the seconds they took."""
    from repro_torch.models import lm as tlm

    S = tok.shape[1]
    t0 = time.perf_counter()
    with torch.inference_mode():
        tt = torch.from_numpy(tok).to(device)
        tfull = tlm.forward(tc, tp, tt)[0][:, -1].float().cpu().numpy()
        tcache = tlm.init_cache(tc, 1, S + 4, device)
        _, tcache = tlm.prefill(tc, tp, tt[:, : S - 1], tcache)
        tdec = tlm.decode_step(tc, tp, tt[:, S - 1:], S - 1, tcache)[0][:, 0].float().cpu().numpy()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return tdec, tfull, time.perf_counter() - t0


def report(what, rows):
    for name, dec, full, secs in rows:
        err, scale, past = gap(dec, full)
        print(f"{what}: {name}: decode after prefill vs forward's last logits: max abs "
              f"{err:.6g} at logit scale {scale:.6g} ({err / scale:.4g} of it), {past} of "
              f"{dec.size} past rtol = atol = {TOL} ({secs:.1f} s)", flush=True)


def port_only(args):
    from repro_torch.configs import ARCHS, SMOKE
    from repro_torch.models import blocks
    from repro_torch.models import lm as tlm

    tc = cut((SMOKE if args.smoke else ARCHS)[args.arch], args.layers)
    S = args.seq
    tp = tlm.init_params(tc, 0, "cpu")
    tok = np.random.default_rng(S).integers(0, tc.vocab, (1, S)).astype(np.int32)
    what = (f"{args.arch} {'smoke' if args.smoke else 'full'} width, {args.layers} layers, "
            f"S = {S}, bfloat16 compute, port's parameters (seed 0)")
    cpu = port_run(tc, tp, tok, "cpu")
    report(what, [("port, CPU", *cpu)])
    if args.cuda:
        tp = blocks.tree_map(lambda x: x.to("cuda"), tp)
        card = port_run(tc, tp, tok, "cuda")
        report(what, [(f"port, {torch.cuda.get_device_name(0)}", *card)])
        print(f"{what}: card vs CPU: forward {np.abs(card[1] - cpu[1]).max():.6g}, decode "
              f"{np.abs(card[0] - cpu[0]).max():.6g} (max abs)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--port-only", action="store_true", help="the port alone, no JAX")
    ap.add_argument("--cuda", action="store_true", help="with --port-only: the card too")
    args = ap.parse_args(argv)
    if args.port_only:
        return port_only(args)

    import jax
    import jax.numpy as jnp

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tests"))
    from _torch_parity import port_arch

    from repro.configs import ARCHS, SMOKE
    from repro.models import lm as jlm
    from repro_torch.models import bridge

    jc = cut((SMOKE if args.smoke else ARCHS)[args.arch], args.layers)
    tc = port_arch(jc)
    S = args.seq
    jp = jax.jit(functools.partial(jlm.init_params, jc))(jax.random.PRNGKey(0))
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    tok = np.random.default_rng(S).integers(0, jc.vocab, (1, S)).astype(np.int32)

    t0 = time.perf_counter()
    jfull = np.asarray(jax.jit(lambda p, t: jlm.forward(jc, p, t)[0][:, -1])(jp, tok))
    cache = jlm.init_cache(jc, 1, S + 4)
    _, cache = jax.jit(lambda p, t, c: jlm.prefill(jc, p, t, c))(jp, tok[:, : S - 1], cache)
    jdec = np.asarray(jax.jit(lambda p, t, i, c: jlm.decode_step(jc, p, t, i, c)[0][:, 0])(
        jp, tok[:, S - 1:], jnp.asarray(S - 1, jnp.int32), cache))
    t_j = time.perf_counter() - t0
    del cache, jp

    tdec, tfull, t_t = port_run(tc, tp, tok, "cpu")
    what = (f"{args.arch} {'smoke' if args.smoke else 'full'} width, {args.layers} layers, "
            f"S = {S}, bfloat16 compute, CPU")
    report(what, [("reference", jdec, jfull, t_j), ("port", tdec, tfull, t_t)])
    print(f"{what}: port vs reference: forward {np.abs(tfull - jfull).max():.6g}, "
          f"decode {np.abs(tdec - jdec).max():.6g} (max abs)")


if __name__ == "__main__":
    main()
