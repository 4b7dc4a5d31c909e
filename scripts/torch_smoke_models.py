"""Dev smoke of the PyTorch port's models: every arch's reduced config does
forward, loss, prefill and decode.

    PYTHONPATH=src python scripts/torch_smoke_models.py               # the CUDA card
    PYTHONPATH=src python scripts/torch_smoke_models.py --device cpu  # plain PyTorch
    PYTHONPATH=src python scripts/torch_smoke_models.py --device cpu --arch whisper-base

The counterpart of ``scripts/smoke_models.py``: the same batch (B = 2,
S = 32, frame embeddings of ones for the encoder arch, M-RoPE positions
for the VLM), the same four calls and the same line an arch. Parameters
and tokens come from one seeded ``torch.Generator`` on the device.
"""
import argparse
import time

import torch

from repro_torch.configs import get_smoke, list_archs
from repro_torch.core.engine import _resolve_device
from repro_torch.models import lm

B, S = 2, 32


def smoke(cfg, dev) -> dict:
    """Forward, ``loss_fn``, ``prefill`` and one ``decode_step`` of ``cfg``
    on ``dev``: the loss, whether the logits' shapes are right and whether
    the loss and the decode logits are finite."""
    gen = torch.Generator(device=dev).manual_seed(0)
    params = lm.init_params(cfg, gen, dev)
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen, device=dev, dtype=torch.int32)
    batch = {"tokens": tokens, "labels": tokens}
    if cfg.enc_layers > 0:
        batch["enc_embeds"] = torch.ones((B, cfg.enc_seq, cfg.d_model), device=dev)
    if cfg.mrope_sections is not None:
        base = torch.arange(S, dtype=torch.int32, device=dev)[None].expand(B, S)
        batch["pos3"] = base[None].expand(3, B, S).contiguous()
    with torch.no_grad():
        loss, _ = lm.loss_fn(cfg, params, batch)
        logits, _ = lm.forward(cfg, params, tokens, batch.get("pos3"), batch.get("enc_embeds"))
        caches = lm.init_cache(cfg, B, S + 8, dev)
        _, caches = lm.prefill(cfg, params, tokens, caches, batch.get("pos3"),
                               batch.get("enc_embeds"))
        dc_logits, _ = lm.decode_step(cfg, params, tokens[:, -1:],
                                      torch.full((), S, dtype=torch.int32, device=dev), caches,
                                      None, batch.get("enc_embeds"))
    return {
        "loss": float(loss),
        "shapes_ok": (tuple(logits.shape) == (B, S, cfg.vocab)
                      and tuple(dc_logits.shape) == (B, 1, cfg.vocab)),
        "finite": bool(torch.isfinite(loss)) and bool(torch.isfinite(dc_logits).all()),
    }


def report(name: str, r: dict, wall_s: float) -> str:
    """The line ``scripts/smoke_models.py`` prints for arch ``name``."""
    return (f"{name:>22}: loss={r['loss']:.3f} shapes_ok={r['shapes_ok']} "
            f"finite={r['finite']} wall={wall_s:.1f}s")


def main(argv=None):
    """Every arch (or those given by ``--arch``); returns their results by
    name, each with its seconds under ``"wall"``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--arch", action="append", choices=list_archs(),
                    help="repeatable; default: every arch")
    args = ap.parse_args(argv)
    dev = _resolve_device(args.device)
    results = {}
    for name in args.arch or list_archs():
        t0 = time.time()
        r = smoke(get_smoke(name), dev)
        r["wall"] = time.time() - t0
        print(report(name, r, r["wall"]))
        results[name] = r
    return results


if __name__ == "__main__":
    main()
