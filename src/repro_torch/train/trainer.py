"""Fault-tolerant training loop: checkpoint / restart, straggler breaker,
re-meshing. A port of ``repro.train.trainer`` on one device.

Where the reference takes a mesh, this trainer takes a ``device`` (the CUDA
card unless ``"cpu"``); everything device-dependent (the step function) is
built by ``_build(device)``, so ``remesh`` after a (simulated) failure is
"checkpoint -> rebuild -> restore", the same code path as a cold restart.
The step synchronizes once (reading the loss), where the reference calls
``block_until_ready``, so the straggler monitor times the whole step.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.core.engine import _resolve_device
from repro_torch.launch import steps as steps_mod
from repro_torch.models import bridge, lm
from repro_torch.models.common import ArchConfig
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


class Trainer:
    def __init__(
        self,
        cfg: ArchConfig,
        tcfg: TrainerConfig,
        device,
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
        self._build(_resolve_device(device))

    # ---- device-dependent construction (re-meshing re-enters here) ----------
    def _build(self, device):
        self.device = device
        self.train_step = steps_mod.make_train_step(self.cfg, self.tcfg.opt)

    def _abstract(self):
        return {
            "params": steps_mod.abstract_params(self.cfg),
            "opt": steps_mod.abstract_opt_state(self.cfg, self.tcfg.opt),
        }

    def _place(self, key: str, a: np.ndarray) -> torch.Tensor:
        return bridge.tensor_from_numpy(a, self.device)

    def init_state(self, seed: int = 0):
        params = lm.init_params(self.cfg, seed, self.device)
        opt_state = opt.init_opt_state(self.tcfg.opt, params)
        return params, opt_state, 0

    def restore_or_init(self, seed: int = 0):
        step, tree = self.checkpointer.restore_latest(self._abstract(), placer=self._place)
        if step is None:
            return self.init_state(seed)
        return tree["params"], tree["opt"], step

    # ---- re-mesh -------------------------------------------------------------
    def remesh(self, new_device, params, opt_state, step):
        """Failure path: persist, rebuild for the surviving device, restore."""
        self.checkpointer.wait()
        path = f"{self.tcfg.ckpt_dir}/step_{step:08d}"
        ckpt.save(path, step, {"params": params, "opt": opt_state})
        del params, opt_state
        self._build(new_device)
        tree = ckpt.restore(path, self._abstract(), placer=self._place)
        self.monitor.reset()
        return tree["params"], tree["opt"], step

    # ---- the loop ------------------------------------------------------------
    def run(self, seed: int = 0) -> Dict[str, Any]:
        params, opt_state, start_step = self.restore_or_init(seed)
        losses, step_seconds = [], []
        for step in range(start_step, self.tcfg.total_steps):
            if self.fail_injector(step):
                # simulated node loss: re-mesh onto the same device (real
                # deployments pass the survivors')
                params, opt_state, step = self.remesh(self.device, params, opt_state, step)
            batch = {k: torch.from_numpy(np.asarray(v)).to(self.device)
                     for k, v in next(self.data).items()}
            t0 = time.perf_counter()
            params, opt_state, metrics = self.train_step(params, opt_state, batch)
            loss = float(metrics["loss"])  # the step's one synchronize
            dt = time.perf_counter() - t0
            step_seconds.append(dt)
            verdict = self.monitor.observe(dt)
            if verdict == "tripped":
                params, opt_state, step = self.remesh(self.device, params, opt_state, step)
            losses.append(loss)
            if step % self.tcfg.log_every == 0:
                self.metrics_log.append({"step": step, "loss": loss})
            if step > 0 and step % self.tcfg.ckpt_every == 0:
                self.checkpointer.save_async(step, {"params": params, "opt": opt_state})
        self.checkpointer.wait()
        return {
            "final_loss": losses[-1] if losses else float("nan"),
            "losses": np.asarray(losses),
            "steps": len(losses),
            "step_seconds": np.asarray(step_seconds),
        }
