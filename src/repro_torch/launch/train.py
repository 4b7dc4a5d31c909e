"""Training driver: ``python -m repro_torch.launch.train --arch <id> [...]``.

A port of ``repro.launch.train``: selects any of the 10 assigned
architectures (full or smoke-reduced), builds the data pipeline and the
fault-tolerant trainer, and runs on one device: the CUDA card unless
``--device cpu`` (without a card it raises). ``--smoke`` takes the reduced
config. Prints ``arch=... steps=... first_loss=... final_loss=...``.
"""

from __future__ import annotations

import argparse
import os
import tempfile


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", default=None,
                    help="not ported yet: a device mesh needs parallel/sharding.py and "
                         "launch/mesh.py (a later slice); the driver runs on one device")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.mesh:
        ap.error("--mesh is not ported yet (parallel/sharding.py, launch/mesh.py)")

    from repro_torch.configs import get, get_smoke
    from repro_torch.core.engine import _resolve_device
    from repro_torch.train import data as data_mod
    from repro_torch.train import optimizer as opt
    from repro_torch.train.trainer import Trainer, TrainerConfig

    dev = _resolve_device(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get(args.arch)
    tcfg = TrainerConfig(
        total_steps=args.steps,
        ckpt_every=args.ckpt_every,
        ckpt_dir=args.ckpt_dir,
        opt=opt.OptConfig(
            lr=args.lr, warmup_steps=max(args.steps // 20, 1),
            total_steps=args.steps, compress_grads=args.compress_grads,
        ),
    )
    pipeline = data_mod.make_pipeline(cfg.vocab, args.batch, args.seq, seed=0)
    trainer = Trainer(cfg, tcfg, dev, pipeline)
    out = trainer.run()
    print(
        f"arch={cfg.name} steps={out['steps']} "
        f"first_loss={out['losses'][0]:.4f} final_loss={out['final_loss']:.4f}"
    )
    return out


if __name__ == "__main__":
    main()
