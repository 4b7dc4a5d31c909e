"""End-to-end training driver on PyTorch: train a (reduced) assigned
architecture for a few hundred steps on the synthetic packed-LM pipeline
with checkpointing, straggler monitoring and fault-tolerant restart.

    PYTHONPATH=src python examples/torch_train_lm.py --arch qwen3-1.7b --steps 200
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu --steps 20

The counterpart of ``examples/train_lm.py`` on ``repro_torch``: the same
flags, trainer settings and printed lines, on a (1, 1) ("data", "model")
mesh over a one-rank process group of its own (NCCL on the card, gloo on
the CPU; an open group is used as it is). Any arch but whisper-base works
(--arch olmoe-1b-7b exercises the MoE path with the laminar router; --arch
mamba2-130m the SSD path; ...): the pipeline feeds no frame embeddings. On
the card by default; without one it raises unless given ``--device cpu``.
Its checkpoints go to a folder of their own, never the reference
example's.
"""

import argparse
import os
import tempfile

from repro_torch.configs import get_smoke
from repro_torch.core.engine import _resolve_device
from repro_torch.launch.mesh import make_mesh, process_group
from repro_torch.train import data as data_mod
from repro_torch.train import optimizer as opt
from repro_torch.train.trainer import Trainer, TrainerConfig

DEFAULT_CKPT_DIR = os.path.join(tempfile.gettempdir(), "repro_torch_example_ckpt")


def main(argv=None):
    """Trains and prints; returns the trainer's result with its
    ``metrics_log`` under ``"log"``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    dev = _resolve_device(args.device)
    cfg = get_smoke(args.arch)
    tcfg = TrainerConfig(
        total_steps=args.steps,
        ckpt_every=max(args.steps // 4, 1),
        log_every=max(args.steps // 20, 1),
        ckpt_dir=args.ckpt_dir,
        opt=opt.OptConfig(lr=3e-3, warmup_steps=10, total_steps=args.steps),
    )
    with process_group(dev):
        trainer = Trainer(
            cfg, tcfg, make_mesh((1, 1), ("data", "model"), dev.type),
            data_mod.make_pipeline(cfg.vocab, args.batch, args.seq, seed=0),
        )
        out = trainer.run()
    print(f"\narch={cfg.name} ({cfg.family})")
    for m in trainer.metrics_log:
        print(f"  step {m['step']:>4}: loss {m['loss']:.4f}")
    print(f"final loss after {out['steps']} steps: {out['final_loss']:.4f}")
    return {**out, "log": trainer.metrics_log}


if __name__ == "__main__":
    main()
