"""Fault-tolerant training loop: checkpoint / restart, straggler breaker,
elastic re-meshing. A port of ``repro.train.trainer``.

The trainer takes a ``DeviceMesh`` (``launch.mesh``), as the reference
takes a mesh, or a device (the CUDA card unless ``"cpu"``) for the
one-device path. Everything mesh-dependent (the specs, the step) is built
by ``_build(mesh_or_device)``, so ``remesh`` after a (simulated or real)
failure is "checkpoint -> new mesh -> rebuild -> restore", the same code
path as a cold restart.

Under a mesh the parameters and both Adam moments are DTensors placed by
``sharding.tree_param_specs`` (ZeRO-3 over the DP axes, tensor parallel
over "model"), the Adam step is replicated, and each batch is placed by
``tokens_spec``. A
checkpoint is written in the reference's on-disk format from the gathered
tensors (``full_tensor()``, a collective every rank joins): rank 0 writes,
the others wait at a barrier. A restore places every array again under the
current mesh's specs, so a checkpoint restores under any mesh.

The step is compiled, as the reference jits it in ``_build``
(``jax.jit(step_fn, donate_argnums=(0, 1) if tcfg.donate else ())``):
``launch.steps.CompiledTrainStep``, on one device and under a mesh
alike (on the card DTensor's dispatch and its one-rank NCCL collectives
capture at (1, 1)). On CUDA the first step of each build runs eagerly as
the warm-up and the body is captured as a CUDA graph, then every step
replays it; on the CPU the same body runs. The step builds at its first
call after ``_build`` (a re-mesh makes a new step) and whenever it is
handed a new state (``restore_or_init`` at a run's start, a restart): one
warm-up step each, never an extra one. ``TrainerConfig.donate`` (default
True, the reference's) updates the state in place; ``donate=False``
leaves the tensors a run starts from as they were and trains copies of
them, taken once a build.

The step synchronizes once (reading the loss), where the reference calls
``block_until_ready``, so the straggler monitor times the whole step, a
build's warm-up and capture included, as the reference's first step
includes its compilation.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.core.engine import _resolve_device
from repro_torch.launch import steps as steps_mod
from repro_torch.models import bridge, lm, regions
from repro_torch.models.blocks import tree_map
from repro_torch.models.common import ArchConfig
from repro_torch.parallel import sharding
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt
from repro_torch.train.straggler import StragglerMonitor


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 25
    ckpt_dir: str = dataclasses.field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    log_every: int = 10
    opt: opt.OptConfig = dataclasses.field(default_factory=opt.OptConfig)
    donate: bool = True


class Trainer:
    def __init__(
        self,
        cfg: ArchConfig,
        tcfg: TrainerConfig,
        mesh_or_device,
        data_iter,
        fail_injector: Optional[Callable[[int], bool]] = None,
    ):
        self.cfg = cfg
        self.tcfg = tcfg
        self.data = data_iter
        self.monitor = StragglerMonitor()
        self.checkpointer = ckpt.AsyncCheckpointer(tcfg.ckpt_dir)
        self.fail_injector = fail_injector or (lambda step: False)
        self.metrics_log: list = []
        self._build(mesh_or_device)

    # ---- mesh-dependent construction (elastic re-mesh re-enters here) -------
    def _build(self, mesh_or_device):
        if isinstance(mesh_or_device, DeviceMesh):
            self.mesh = mesh_or_device
            dt = self.mesh.device_type
            self.device = torch.device(dt, torch.cuda.current_device()) if dt == "cuda" \
                else torch.device(dt)
            self.pspecs = sharding.tree_param_specs(self.mesh, steps_mod.abstract_params(self.cfg))
        else:
            self.mesh = None
            self.device = _resolve_device(mesh_or_device)
            self.pspecs = None
        self.train_step = steps_mod.CompiledTrainStep(self.cfg, self.tcfg.opt,
                                                      donate=self.tcfg.donate)

    def _abstract(self):
        return {
            "params": steps_mod.abstract_params(self.cfg),
            "opt": steps_mod.abstract_opt_state(self.cfg, self.tcfg.opt),
        }

    def _spec(self, key: str, shape) -> tuple:
        """The spec of checkpoint leaf ``key`` (``params/<path>``,
        ``opt/.mu/<path>``, ``opt/.step``) under the current mesh."""
        path = key.split("/", 1)[1]
        if path.startswith("."):  # an Adam field
            if "/" not in path:
                return ()  # the step: replicated
            path = path.split("/", 1)[1]
        return sharding.param_spec(self.mesh, path, tuple(shape))

    def _place(self, key: str, a: np.ndarray) -> torch.Tensor:
        t = bridge.tensor_from_numpy(a, self.device)
        if self.mesh is None:
            return t
        return sharding.distribute(self.mesh, t, self._spec(key, a.shape))

    def _distribute_state(self, params, opt_state):
        """Full tensors (the same on every rank) placed under the mesh."""
        if self.mesh is None:
            return params, opt_state
        d = lambda tree, specs: sharding.distribute(self.mesh, tree, specs)  # noqa: E731
        return d(params, self.pspecs), opt.AdamState(
            step=d(opt_state.step, ()), mu=d(opt_state.mu, self.pspecs),
            nu=d(opt_state.nu, self.pspecs),
            err=None if opt_state.err is None else d(opt_state.err, self.pspecs))

    def init_state(self, seed: int = 0):
        params = lm.init_params(self.cfg, seed, self.device)
        opt_state = opt.init_opt_state(self.tcfg.opt, params)
        params, opt_state = self._distribute_state(params, opt_state)
        return params, opt_state, 0

    def restore_or_init(self, seed: int = 0):
        step, tree = self.checkpointer.restore_latest(self._abstract(), placer=self._place)
        if step is None:
            return self.init_state(seed)
        return tree["params"], tree["opt"], step

    # ---- checkpoints under a mesh ------------------------------------------
    def _writer(self) -> bool:
        return self.mesh is None or dist.get_rank() == 0

    def _gathered(self, tree):
        """Every DTensor leaf's full value (a collective on every rank)."""
        return tree if self.mesh is None else tree_map(regions.full, tree)

    def _wait(self) -> None:
        """Wait for the checkpoint in flight; under a mesh every rank waits
        for rank 0's write at a barrier."""
        self.checkpointer.wait()
        if self.mesh is not None:
            dist.barrier()

    def save(self, step: int, params, opt_state) -> None:
        """Synchronous checkpoint of ``step`` (every rank calls it)."""
        self._wait()
        tree = self._gathered({"params": params, "opt": opt_state})
        if self._writer():
            ckpt.save(f"{self.tcfg.ckpt_dir}/step_{step:08d}", step, tree)
        self._wait()

    # ---- elastic re-mesh -----------------------------------------------------
    def remesh(self, new_mesh_or_device, params, opt_state, step):
        """Failure path: persist, rebuild for the surviving mesh, restore."""
        self.save(step, params, opt_state)
        del params, opt_state
        self._build(new_mesh_or_device)
        tree = ckpt.restore(f"{self.tcfg.ckpt_dir}/step_{step:08d}", self._abstract(),
                            placer=self._place)
        self.monitor.reset()
        return tree["params"], tree["opt"], step

    def _batch(self, b):
        batch = {k: torch.from_numpy(np.asarray(v)).to(self.device) for k, v in b.items()}
        if self.mesh is None:
            return batch
        return sharding.distribute(self.mesh, batch, sharding.tokens_spec(self.mesh))

    # ---- the loop ------------------------------------------------------------
    def run(self, seed: int = 0) -> Dict[str, Any]:
        params, opt_state, start_step = self.restore_or_init(seed)
        losses, step_seconds = [], []
        where = self.mesh if self.mesh is not None else self.device
        for step in range(start_step, self.tcfg.total_steps):
            if self.fail_injector(step):
                # simulated node loss: re-mesh onto the same devices (real
                # deployments pass the survivors' mesh)
                params, opt_state, step = self.remesh(where, params, opt_state, step)
            batch = self._batch(next(self.data))
            t0 = time.perf_counter()
            params, opt_state, metrics = self.train_step(params, opt_state, batch)
            loss = float(regions.full(metrics["loss"]))  # the step's one synchronize
            dt = time.perf_counter() - t0
            step_seconds.append(dt)
            verdict = self.monitor.observe(dt)
            if verdict == "tripped":
                params, opt_state, step = self.remesh(where, params, opt_state, step)
            losses.append(loss)
            if step % self.tcfg.log_every == 0:
                self.metrics_log.append({"step": step, "loss": loss})
            if step > 0 and step % self.tcfg.ckpt_every == 0:
                self._wait()
                tree = self._gathered({"params": params, "opt": opt_state})
                if self._writer():
                    self.checkpointer.save_async(step, tree)
        self._wait()
        self.state = (params, opt_state)
        return {
            "final_loss": losses[-1] if losses else float("nan"),
            "losses": np.asarray(losses),
            "steps": len(losses),
            "step_seconds": np.asarray(step_seconds),
        }
