"""The compiled train step (``repro_torch.launch.steps.CompiledTrainStep``,
the reference's ``jax.jit(step_fn, donate_argnums=(0, 1))``) and the
trainer that runs it, on the CPU at smoke width.

On the CPU the compiled step runs its in-place body over its static
buffers, the body a CUDA graph captures on the card. Here:

  * 5 steps of the body for qwen3-1.7b, olmoe-1b-7b, recurrentgemma-2b,
    mamba2-130m and gemma2-9b in float32: every metric, the parameters and
    the Adam state equal eager ``make_train_step``'s bit for bit (which
    ``tests/test_torch_train.py`` holds to the jitted reference for each);
  * for qwen3-1.7b and olmoe-1b-7b, from the reference's parameters, the
    losses, grad norms and final parameters within the bounds of
    ``tests/test_torch_train.py`` (``LOSS_RTOL`` 1e-6, ``GNORM_RTOL`` 1e-5,
    ``STEP_PARAM_LR_TOL`` 0.25 lr) of the jitted, donating reference step
    (``lr`` and the MoE dropped slots equal);
  * on a one-rank gloo (1, 1) mesh the body over DTensors equals eager
    ``make_train_step`` over the same DTensors bit for bit;
  * the static outputs are the same tensors at every call, overwritten by
    the next; a new batch shape builds anew;
  * ``Trainer.run`` builds its step anew after a re-mesh (the failure
    injector, the straggler breaker) with the losses of a run without one,
    and after a restart from a checkpoint with the losses of eager steps
    from that checkpoint.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from test_torch_train import (
    GNORM_RTOL,
    LOSS_RTOL,
    STEP_PARAM_LR_TOL,
    TRAIN_ARCHS,
    _batches,
    _jb,
    _rel,
    _tb,
    _train_case,
    _trainer,
)

from repro.configs import SMOKE as J_SMOKE
from repro.launch import steps as jsteps
from repro.train import optimizer as jopt
from repro_torch.configs import SMOKE as T_SMOKE
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import bridge, regions
from repro_torch.models import lm as tlm
from repro_torch.parallel import sharding
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import data as tdata
from repro_torch.train import optimizer as topt

STEPS = 5


def _copy(p, st):
    clone = lambda t: None if t is None else topt.tree_map(torch.clone, t)  # noqa: E731
    return clone(p), topt.AdamState(*(clone(x) for x in st))


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_compiled_step_equals_eager(arch):
    tc = dataclasses.replace(T_SMOKE[arch], compute_dtype=torch.float32)
    ocfg = topt.OptConfig(lr=1e-3, warmup_steps=2, total_steps=STEPS)
    tp = tlm.init_params(tc, 0, "cpu")
    ts = topt.init_opt_state(ocfg, tp)
    ep, es = _copy(tp, ts)
    step, eager = tsteps.CompiledTrainStep(tc, ocfg), tsteps.make_train_step(tc, ocfg)
    for b in _batches(J_SMOKE[arch], STEPS):
        tp, ts, tm = step(tp, ts, _tb(b))
        ep, es, em = eager(ep, es, _tb(b))
        assert tm.keys() == em.keys()
        assert all(torch.equal(tm[k], em[k]) for k in tm), {k: (tm[k], em[k]) for k in tm}
    assert step.builds == 1 and step.graph is None  # the CPU runs the body
    assert all(torch.equal(a, b) for a, b in zip(topt.sorted_leaves((tp, ts)),
                                                 topt.sorted_leaves((ep, es)), strict=True))


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "olmoe-1b-7b"])
def test_compiled_step_within_the_donating_reference(arch):
    """Against ``jax.jit(make_train_step, donate_argnums=(0, 1))`` from the
    reference's parameters (the eager step is held to the jitted reference
    for every arch of ``TRAIN_ARCHS`` in ``tests/test_torch_train.py``)."""
    jc, tc, jp, tp, jo, to = _train_case(arch, "float32")
    ts = topt.init_opt_state(to, tp)
    step = tsteps.CompiledTrainStep(tc, to)
    jstep = jax.jit(jsteps.make_train_step(jc, jo), donate_argnums=(0, 1))
    js = jopt.init_opt_state(jo, jp)
    for b in _batches(jc, STEPS):
        tp, ts, tm = step(tp, ts, _tb(b))
        jp, js, jm = jstep(jp, js, _jb(b))
        assert set(tm) == set(jm)
        assert float(jm["lr"]) == float(tm["lr"])
        assert int(jm["moe_dropped_slots"]) == int(tm["moe_dropped_slots"])
        assert _rel(jm["loss"], tm["loss"]) <= LOSS_RTOL
        assert _rel(jm["grad_norm"], tm["grad_norm"]) <= GNORM_RTOL
    for a, t in zip(jax.tree_util.tree_leaves(jp), topt.sorted_leaves(tp), strict=True):
        assert np.abs(np.asarray(a) - t.numpy()).max() <= STEP_PARAM_LR_TOL * to.lr


def test_compiled_step_on_a_one_rank_mesh_equals_eager(tmp_path):
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), "cpu")
        tc = dataclasses.replace(T_SMOKE["olmoe-1b-7b"], compute_dtype=torch.float32)
        ocfg = topt.OptConfig(lr=1e-3, warmup_steps=1, total_steps=4)
        p = tlm.init_params(tc, 0, "cpu")
        st = topt.init_opt_state(ocfg, p)
        specs = sharding.tree_param_specs(mesh, p)

        def placed():
            q, s = _copy(p, st)
            d = lambda tree, sp: sharding.distribute(mesh, tree, sp)  # noqa: E731
            return d(q, specs), topt.AdamState(step=d(s.step, ()), mu=d(s.mu, specs),
                                               nu=d(s.nu, specs), err=None)

        (cp, cs), (ep, es) = placed(), placed()
        step, eager = tsteps.CompiledTrainStep(tc, ocfg), tsteps.make_train_step(tc, ocfg)
        for b in _batches(J_SMOKE["olmoe-1b-7b"], 3):
            tb = sharding.distribute(mesh, _tb(b), sharding.tokens_spec(mesh))
            cp, cs, cm = step(cp, cs, tb)
            ep, es, em = eager(ep, es, tb)
            assert all(torch.equal(regions.full(cm[k]), regions.full(em[k])) for k in cm)
        for a, b in zip(topt.sorted_leaves((cp, cs)), topt.sorted_leaves((ep, es)), strict=True):
            assert torch.equal(regions.full(a), regions.full(b))
    finally:
        dist.destroy_process_group()


def test_static_outputs_are_overwritten_by_the_next_call():
    tc = T_SMOKE["mamba2-130m"]
    ocfg = topt.OptConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    p = tlm.init_params(tc, 0, "cpu")
    st = topt.init_opt_state(ocfg, p)
    step = tsteps.CompiledTrainStep(tc, ocfg)
    b0, b1 = (_tb(b) for b in _batches(J_SMOKE["mamba2-130m"], 2))
    p, st, m0 = step(p, st, b0)
    first = {k: v.clone() for k, v in m0.items()}
    p, st, m1 = step(p, st, b1)
    assert all(m1[k] is m0[k] for k in m0)  # the same static outputs ...
    assert not torch.equal(m0["loss"], first["loss"])  # ... holding the second step's values
    assert not torch.equal(m0["lr"], first["lr"])
    assert step.builds == 1
    longer = {k: torch.cat([v, v], dim=1) for k, v in b0.items()}
    p, st, m2 = step(p, st, longer)  # another batch shape: a build, its step eager
    assert step.builds == 2 and m2["loss"] is not m1["loss"] and int(st.step) == 3


@pytest.mark.parametrize("how", ["fail_injector", "straggler"])
def test_trainer_rebuilds_its_step_after_a_remesh(tmp_path, how):
    """A re-mesh (checkpoint, ``_build``, restore) at step 3 makes a new
    compiled step, built on the restored state at its first call; the
    losses and final state equal a run without the re-mesh."""
    want = _trainer(tmp_path / "plain", total_steps=6)
    want_losses = want.run()["losses"]
    t = _trainer(tmp_path / how, total_steps=6, fail_at=3 if how == "fail_injector" else None)
    seen, real = [], t.monitor.observe

    def observe(dt):  # after each step: the step object that ran it
        seen.append(t.train_step)
        if how == "straggler" and len(seen) == 3:  # step 2 trips the breaker
            return "tripped"
        return real(dt)

    t.monitor.observe = observe
    out = t.run()
    np.testing.assert_array_equal(out["losses"], want_losses)
    assert len({id(s) for s in seen[:3]}) == 1 and len({id(s) for s in seen[3:]}) == 1
    assert seen[2] is not seen[3] and seen[2].builds == seen[3].builds == 1
    assert all(torch.equal(a, b) for a, b in zip(topt.sorted_leaves(t.state),
                                                 topt.sorted_leaves(want.state), strict=True))


def test_restart_builds_on_the_restored_state(tmp_path):
    """A second run resumes at the newest checkpoint (step 4) on a new
    build: its losses are eager ``make_train_step``'s from that checkpoint
    (read before the run, which writes step 4 again) on the batches of a
    fresh pipeline."""
    _trainer(tmp_path, total_steps=5).run()
    t = _trainer(tmp_path, total_steps=7)
    tree = tckpt.restore(str(tmp_path / "step_00000004"), t._abstract(),
                         placer=lambda k, a: bridge.tensor_from_numpy(a, "cpu"))
    p, st = tree["params"], tree["opt"]
    eager = tsteps.make_train_step(t.cfg, t.tcfg.opt)
    it = tdata.make_pipeline(t.cfg.vocab, batch=2, seq=16, seed=0)
    want = []
    for _ in range(3):
        p, st, m = eager(p, st, _tb(next(it)))
        want.append(float(m["loss"]))
    out = t.run()
    assert out["steps"] == 3 and t.train_step.builds == 1
    np.testing.assert_array_equal(out["losses"], np.asarray(want))
