"""Rank functions for ``tests/test_torch_mesh_train.py``, run by
``repro_torch.parallel.local.spawn_ranks`` in fresh processes (so this
module imports no JAX). Each returns numpy arrays, the same on every rank."""

from __future__ import annotations

from repro_torch.configs import get_smoke
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import regions
from repro_torch.models.blocks import tree_flatten
from repro_torch.train import data as tdata
from repro_torch.train import optimizer as topt
from repro_torch.train.trainer import Trainer, TrainerConfig

B, S = 2, 16
OPT = topt.OptConfig(lr=1e-3, warmup_steps=1, total_steps=4)


def trainer(arch, where, steps, ckpt_dir, ckpt_every=1000, cfg=None):
    cfg = cfg or get_smoke(arch)
    tcfg = TrainerConfig(total_steps=steps, ckpt_every=ckpt_every, ckpt_dir=ckpt_dir,
                         log_every=1000, opt=OPT)
    return Trainer(cfg, tcfg, where, tdata.make_pipeline(cfg.vocab, B, S, seed=0))


def host(tree) -> dict:
    """Every leaf's full value as numpy, keyed by its checkpoint path."""
    keys, leaves = tree_flatten(tree)
    return {k: regions.full(x).detach().cpu().numpy() for k, x in zip(keys, leaves)}


def train_on_mesh(dev, arch, shape, steps, ckpt_dir, cfg=None):
    """``steps`` trainer steps on a ("data", "model") mesh of ``shape``:
    the losses and the final parameters and optimizer state."""
    tr = trainer(arch, make_mesh(shape, ("data", "model"), "cpu"), steps, ckpt_dir, cfg=cfg)
    out = tr.run()
    params, opt_state = tr.state
    return {"losses": out["losses"], "state": host({"params": params, "opt": opt_state})}


def remesh_round_trip(dev, arch, ckpt_dir):
    """Train 2 steps under (2, 1), then re-mesh onto (1, 2) through a
    checkpoint: the state before and after, and a rank's shard shape of a
    column-parallel leaf under both meshes."""
    tr = trainer(arch, make_mesh((2, 1), ("data", "model"), "cpu"), 2, ckpt_dir)
    tr.run()
    params, opt_state = tr.state
    before = host({"params": params, "opt": opt_state})
    leaf = lambda p: p["stack"]["b0"]["mixer"]["wq"]  # noqa: E731
    where_before = tuple(leaf(params).to_local().shape)
    params, opt_state, step = tr.remesh(make_mesh((1, 2), ("data", "model"), "cpu"),
                                        params, opt_state, 2)
    return {"before": before, "after": host({"params": params, "opt": opt_state}),
            "step": step, "local_shapes": (where_before, tuple(leaf(params).to_local().shape)),
            "mesh": tuple(tr.mesh.shape)}
