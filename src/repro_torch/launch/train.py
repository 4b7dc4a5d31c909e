"""Training driver: ``python -m repro_torch.launch.train --arch <id> [...]``.

A port of ``repro.launch.train``: selects any of the 10 assigned
architectures (full or smoke-reduced), builds the data pipeline and the
fault-tolerant trainer, and runs: on the CUDA card unless ``--device cpu``
(without a card it raises). ``--smoke`` takes the reduced config.

``--mesh DxM`` trains on a ("data", "model") ``DeviceMesh`` of D x M ranks
over the default process group: the one already open in this process, else
the one ``torchrun`` describes (``torchrun --nproc-per-node N -m
repro_torch.launch.train --mesh DxM ...``: NCCL, one card a rank; gloo
with ``--device cpu``), else a one-rank group of its own (``--mesh 1x1``).
Without ``--mesh`` it trains on one device. Prints ``arch=... steps=...
first_loss=... final_loss=...`` (rank 0). :func:`run` is the same run for an
``ArchConfig`` given directly (a depth cut, say), without the flags.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import tempfile

import torch.distributed as dist

DEFAULT_CKPT_DIR = os.path.join(tempfile.gettempdir(), "repro_torch_train_ckpt")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", default=None,
                    help='e.g. 2x4 ("data" x "model" ranks; default: one device)')
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    from repro_torch.configs import get, get_smoke

    cfg = get_smoke(args.arch) if args.smoke else get(args.arch)
    return run(cfg, steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr,
               ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every, mesh=args.mesh,
               compress_grads=args.compress_grads, device=args.device)


def run(cfg, *, steps: int = 100, batch: int = 8, seq: int = 128, lr: float = 1e-3,
        ckpt_dir: str = DEFAULT_CKPT_DIR, ckpt_every: int = 50, mesh: str | None = None,
        compress_grads: bool = False, device="cuda", warmup_steps: int | None = None):
    """The driver's run for the ``ArchConfig`` ``cfg``, with ``main``'s
    options as keywords (``mesh``: ``"DxM"`` or None; ``warmup_steps``:
    the lr warm-up, by default a twentieth of the steps). Returns the
    trainer's result."""
    from repro_torch.core.engine import _resolve_device
    from repro_torch.launch.mesh import make_mesh, process_group
    from repro_torch.train import data as data_mod
    from repro_torch.train import optimizer as opt
    from repro_torch.train.trainer import Trainer, TrainerConfig

    dev = _resolve_device(device)
    tcfg = TrainerConfig(
        total_steps=steps,
        ckpt_every=ckpt_every,
        ckpt_dir=ckpt_dir,
        opt=opt.OptConfig(
            lr=lr, warmup_steps=max(steps // 20, 1) if warmup_steps is None else warmup_steps,
            total_steps=steps, compress_grads=compress_grads,
        ),
    )
    pipeline = data_mod.make_pipeline(cfg.vocab, batch, seq, seed=0)
    with process_group(dev) if mesh else contextlib.nullcontext():
        where = dev
        if mesh:
            shape = tuple(int(x) for x in mesh.split("x"))
            where = make_mesh(shape, ("data", "model"), dev.type)
        out = Trainer(cfg, tcfg, where, pipeline).run()
        rank0 = not mesh or dist.get_rank() == 0
    if rank0:
        print(
            f"arch={cfg.name} steps={out['steps']} "
            f"first_loss={out['losses'][0]:.4f} final_loss={out['final_loss']:.4f}"
        )
    return out


if __name__ == "__main__":
    main()
