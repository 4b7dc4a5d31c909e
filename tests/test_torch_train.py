"""The port's training path (``repro_torch.models.lm.loss_fn``,
``repro_torch.train``, ``repro_torch.launch.steps`` / ``train``) against the
JAX package's, on the CPU at smoke width.

The JAX side runs under ``jax.jit`` without a mesh (the reference's own
``Trainer`` fails on this tree under its (1, 1) mesh: ROADMAP C). Inputs
come from numpy with a seed; parameters are the reference's
``lm.init_params`` carried across by ``models.bridge``. What was measured,
and the tolerances it sets (float32 compute unless said):

  * ``loss_fn``: within 1.5e-7 of the reference's loss, both cross-entropy
    branches, with masked and -1 labels. ``LOSS_RTOL`` (1e-6).
  * ``adamw_update`` on given gradients (4 updates, with and without int8
    compression): parameters within 6e-6 lr, moments within 3.1e-7 of their
    scale, the error residual within 1.4e-6; ``grad_norm`` within 3.9e-6;
    the learning rate, the int8 codes and scales bit-equal. The in-place
    update equals the functional one bit for bit. ``PARAM_LR_TOL`` (1e-4 lr
    per update), ``MOMENT_RTOL`` (1e-6), ``ERR_ATOL`` (1e-5).
  * ``schedule``: bit-equal at every step of a run, warmup and cosine.
  * ``make_train_step``, 5 steps of qwen3-1.7b, olmoe-1b-7b,
    recurrentgemma-2b, mamba2-130m and gemma2-9b: losses within 1.6e-7,
    ``grad_norm`` within 1.7e-6, ``lr`` and ``moe_dropped_slots`` equal;
    step-1 gradients within 5.6e-6 of each leaf's scale (``GRAD_TOL``
    1e-5); parameters after 5 steps within 0.041 lr (Adam's first updates
    are +-lr wherever |g| >> eps, so a gradient near 0 can take either
    sign; ``STEP_PARAM_LR_TOL`` 0.25 lr). bfloat16 compute: the forward
    rounds as the reference's, the backward's roundings are PyTorch's;
    losses within 1.6e-4 of themselves after 5 steps (``BF16_RTOL`` 2**-5).
  * data batches and straggler verdicts: equal. Every arch of ``ARCHS``
    takes train steps at smoke width; the trainer's restart, failure
    injection and straggler breaker paths run.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import jax_params, port_arch

from repro.configs import SMOKE as J_SMOKE
from repro.configs import shapes as jshapes
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.train import data as jdata
from repro.train import optimizer as jopt
from repro.train import straggler as jstrag
from repro.train import trainer as jtrainer
from repro_torch.configs import SMOKE as T_SMOKE
from repro_torch.configs import shapes as tshapes
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import blocks as tblocks
from repro_torch.models import bridge
from repro_torch.models import lm as tlm
from repro_torch.train import data as tdata
from repro_torch.train import optimizer as topt
from repro_torch.train import straggler as tstrag
from repro_torch.train.trainer import Trainer, TrainerConfig

LOSS_RTOL = 1e-6
PARAM_LR_TOL = 1e-4
MOMENT_RTOL = 1e-6
ERR_ATOL = 1e-5
GNORM_RTOL = 1e-5
GRAD_TOL = 1e-5
STEP_PARAM_LR_TOL = 0.25
BF16_RTOL = 2.0**-5
TRAIN_ARCHS = ["qwen3-1.7b", "olmoe-1b-7b", "recurrentgemma-2b", "mamba2-130m", "gemma2-9b"]
B, S = 2, 16


def _batches(jc, n, seed=0):
    it = iter(jdata.PackedBatcher(jdata.SyntheticSource(jc.vocab, seed=seed), B, S))
    out = []
    for _ in range(n):
        b = next(it)
        if jc.enc_layers:
            b["enc_embeds"] = np.random.default_rng(1).standard_normal(
                (B, jc.enc_seq, jc.d_model)).astype(np.float32)
        out.append(b)
    return out


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()}


def _rel(a, b) -> float:
    return abs(float(a) - float(b)) / max(abs(float(a)), 1e-30)


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sharded_xent", [False, True])
@pytest.mark.parametrize("labels", ["plain", "masked", "minus_one"])
def test_loss_fn_matches_jax(sharded_xent, labels):
    """Masked labels (-100) drop out; a -1 label reads the last vocab entry
    as ``take_along_axis`` wraps it, and the mask zeroes it."""
    jc = dataclasses.replace(J_SMOKE["qwen3-1.7b"], compute_dtype=jnp.float32,
                             sharded_xent=sharded_xent)
    tc = port_arch(jc)
    jp, tp = jax_params(jc, seed=3)
    b = _batches(jc, 1)[0]
    lab = b["labels"].copy()
    if labels == "masked":
        lab[:, ::3] = -100
    elif labels == "minus_one":
        lab[0, :5] = -1
        lab[1, -1] = -1
    b["labels"] = lab
    want, _ = jax.jit(lambda p, b: jlm.loss_fn(jc, p, b))(jp, _jb(b))
    got, aux = tlm.loss_fn(tc, tp, _tb(b))
    assert np.isfinite(float(got)) and float(aux["loss"]) == float(got)
    assert _rel(want, got) <= LOSS_RTOL, (float(want), float(got))


def test_loss_fn_with_every_label_masked_is_zero():
    tc = dataclasses.replace(T_SMOKE["qwen3-1.7b"], compute_dtype=torch.float32)
    p = tlm.init_params(tc, 0, "cpu")
    b = {"tokens": torch.zeros((1, 4), dtype=torch.int32),
         "labels": torch.full((1, 4), -1, dtype=torch.int32)}
    assert float(tlm.loss_fn(tc, p, b)[0]) == 0.0


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

TREE = {"b": (7, 5), "a": (33,), "c": {"z": (4, 4, 3), "y": (2,)}}


def _tree(f, t=TREE):
    return {k: _tree(f, v) if isinstance(v, dict) else f(v) for k, v in t.items()}


@pytest.mark.parametrize("compress", [False, True])
def test_adamw_update_matches_jax(compress):
    rng = np.random.default_rng(0)
    params = _tree(lambda s: rng.standard_normal(s).astype(np.float32))
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=6, compress_grads=compress)
    jc, tc = jopt.OptConfig(**kw), topt.OptConfig(**kw)
    jp = jax.tree.map(jnp.asarray, params)
    tp = bridge.params_from_numpy(params, "cpu")
    tp_in = bridge.params_from_numpy(params, "cpu")
    js, ts, ts_in = (jopt.init_opt_state(jc, jp), topt.init_opt_state(tc, tp),
                     topt.init_opt_state(tc, tp_in))
    upd = jax.jit(lambda p, g, s: jopt.adamw_update(jc, p, g, s))
    for _ in range(4):
        g = _tree(lambda s: (rng.standard_normal(s) * 3).astype(np.float32))
        jp, js, jst = upd(jp, jax.tree.map(jnp.asarray, g), js)
        tp, ts, tst = topt.adamw_update(tc, tp, bridge.params_from_numpy(g, "cpu"), ts)
        tp_in, ts_in, _ = topt.adamw_update_(tc, tp_in, bridge.params_from_numpy(g, "cpu"), ts_in)
        assert int(js.step) == int(ts.step) == int(ts_in.step)
        assert float(jst["lr"]) == float(tst["lr"])
        assert _rel(jst["grad_norm"], tst["grad_norm"]) <= GNORM_RTOL
        for a, b in zip(jax.tree_util.tree_leaves(jp), topt.sorted_leaves(tp)):
            assert np.abs(np.asarray(a) - b.numpy()).max() <= PARAM_LR_TOL * tc.lr
        for f in ("mu", "nu"):
            for a, b in zip(jax.tree_util.tree_leaves(getattr(js, f)),
                            topt.sorted_leaves(getattr(ts, f))):
                a = np.asarray(a)
                assert np.abs(a - b.numpy()).max() <= MOMENT_RTOL * np.abs(a).max(), f
        if compress:
            for a, b in zip(jax.tree_util.tree_leaves(js.err), topt.sorted_leaves(ts.err)):
                assert np.abs(np.asarray(a) - b.numpy()).max() <= ERR_ATOL
        else:
            assert ts.err is None
        # the in-place update writes the functional update's values
        for a, b in zip(topt.sorted_leaves((tp, ts)), topt.sorted_leaves((tp_in, ts_in))):
            assert torch.equal(a, b)


@pytest.mark.parametrize("kw", [dict(), dict(warmup_steps=3, total_steps=7),
                                dict(warmup_steps=5, total_steps=100, lr=1e-3),
                                dict(warmup_steps=1, total_steps=13, lr=3e-3, min_lr_frac=0.2)])
def test_schedule_matches_jax_at_every_step(kw):
    jc, tc = jopt.OptConfig(**kw), topt.OptConfig(**kw)
    steps = np.arange(0, tc.total_steps + 5, dtype=np.int32)
    want = np.asarray(jax.jit(jax.vmap(lambda s: jopt.schedule(jc, s)))(steps))
    got = topt.schedule(tc, torch.from_numpy(steps)).numpy()
    np.testing.assert_array_equal(want, got)


def test_global_norm_and_int8_match_jax():
    rng = np.random.default_rng(1)
    tree = _tree(lambda s: (rng.standard_normal(s) * 5).astype(np.float32))
    want = float(jax.jit(jopt.global_norm)(jax.tree.map(jnp.asarray, tree)))
    assert _rel(want, topt.global_norm(bridge.params_from_numpy(tree, "cpu"))) <= GNORM_RTOL
    compress = jax.jit(jopt.compress_int8)
    for _ in range(300):  # XLA folds the scale's / 127 into a reciprocal multiply
        g = (rng.standard_normal(17) * rng.uniform(1e-3, 1e2)).astype(np.float32)
        q, s = compress(g)
        tq, ts = topt.compress_int8(torch.from_numpy(g))
        np.testing.assert_array_equal(np.asarray(q), tq.numpy())
        assert float(s) == float(ts)
        np.testing.assert_array_equal(np.asarray(jopt.decompress_int8(q, s)),
                                      topt.decompress_int8(tq, ts).numpy())


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


def _train_case(arch, dtype):
    jc = dataclasses.replace(J_SMOKE[arch], compute_dtype=jnp.dtype(dtype))
    tc = port_arch(jc)
    jp, tp = jax_params(jc, seed=0)
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=5)
    return jc, tc, jp, tp, jopt.OptConfig(**kw), topt.OptConfig(**kw)


@pytest.mark.parametrize("dtype,arch", [("float32", a) for a in TRAIN_ARCHS]
                         + [("bfloat16", "qwen3-1.7b"), ("bfloat16", "mamba2-130m")])
def test_train_step_matches_jax(arch, dtype):
    """5 steps of the port's step (in place, as the trainer runs it) against
    the jitted reference step; float32 also the step-1 gradients."""
    jc, tc, jp, tp, jo, to = _train_case(arch, dtype)
    batches = _batches(jc, 5)
    if dtype == "float32":
        jg = jax.jit(jax.grad(lambda p, b: jlm.loss_fn(jc, p, b)[0]))(jp, _jb(batches[0]))
        p = tblocks.tree_map(lambda x: x.detach().requires_grad_(True), tp)
        leaves = topt.sorted_leaves(p)
        tg = torch.autograd.grad(tlm.loss_fn(tc, p, _tb(batches[0]))[0], leaves, allow_unused=True)
        for a, g in zip(jax.tree_util.tree_leaves(jg), tg):
            a = np.asarray(a)
            g = np.zeros_like(a) if g is None else g.numpy()
            assert np.abs(a - g).max() <= GRAD_TOL * max(np.abs(a).max(), 1e-30)

    jstep = jax.jit(jsteps.make_train_step(jc, jo))
    tstep = tsteps.make_train_step(tc, to)
    js, ts = jopt.init_opt_state(jo, jp), topt.init_opt_state(to, tp)
    for b in batches:
        jp, js, jm = jstep(jp, js, _jb(b))
        tp, ts, tm = tstep(tp, ts, _tb(b))
        assert set(tm) == set(jm)
        assert float(jm["lr"]) == float(tm["lr"])
        assert int(jm["moe_dropped_slots"]) == int(tm["moe_dropped_slots"])
        if dtype == "float32":
            assert _rel(jm["loss"], tm["loss"]) <= LOSS_RTOL
            assert _rel(jm["grad_norm"], tm["grad_norm"]) <= GNORM_RTOL
        else:
            assert _rel(jm["loss"], tm["loss"]) <= BF16_RTOL
    if dtype == "float32":
        for a, t in zip(jax.tree_util.tree_leaves(jp), topt.sorted_leaves(tp)):
            assert np.abs(np.asarray(a) - t.numpy()).max() <= STEP_PARAM_LR_TOL * to.lr


@pytest.mark.parametrize("arch", sorted(T_SMOKE))
def test_every_arch_takes_a_train_step(arch):
    """Every architecture of ``ARCHS`` trains at smoke width on the CPU
    (whisper-base with its stub frame embeddings): finite losses, a grad
    norm, every parameter moved by the update."""
    tc = T_SMOKE[arch]
    p = tlm.init_params(tc, 0, "cpu")
    before = [x.clone() for x in topt.sorted_leaves(p)]
    ocfg = topt.OptConfig(warmup_steps=1)
    st = topt.init_opt_state(ocfg, p)
    step = tsteps.make_train_step(tc, ocfg)
    for b in _batches(J_SMOKE[arch], 2):
        p, st, m = step(p, st, _tb(b))
        assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0
    assert all(not torch.equal(a, b) for a, b in zip(before, topt.sorted_leaves(p)))


def test_functional_step_leaves_its_inputs_and_equals_in_place():
    """The reference's functional ``adamw_update`` on the step's own loss
    gradient leaves its inputs and equals ``make_train_step``, which
    updates the parameters and state in place; the step's dropped slots
    are the loss's."""
    tc = dataclasses.replace(T_SMOKE["olmoe-1b-7b"], compute_dtype=torch.float32)
    p = tlm.init_params(tc, 0, "cpu")
    before = [x.clone() for x in topt.sorted_leaves(p)]
    ocfg = topt.OptConfig(warmup_steps=1)
    st = topt.init_opt_state(ocfg, p)
    b = _tb(_batches(J_SMOKE["olmoe-1b-7b"], 1)[0])
    pg = tblocks.tree_map(lambda x: x.detach().requires_grad_(True), p)
    loss, aux = tlm.loss_fn(tc, pg, b)
    leaves = topt.sorted_leaves(pg)
    by_leaf = {id(x): torch.zeros_like(x) if g is None else g
               for x, g in zip(leaves, torch.autograd.grad(loss, leaves, allow_unused=True))}
    grads = tblocks.tree_map(lambda x: by_leaf[id(x)], pg)
    p1, st1, s1 = topt.adamw_update(ocfg, p, grads, st)
    assert all(torch.equal(x, y) for x, y in zip(before, topt.sorted_leaves(p)))
    assert int(st.step) == 0 and int(st1.step) == 1
    p2, st2, m2 = tsteps.make_train_step(tc, ocfg)(p, st, b)
    assert p2 is p and all(torch.equal(x, y) for x, y in zip(topt.sorted_leaves((p1, st1)),
                                                            topt.sorted_leaves((p2, st2))))
    assert float(m2["loss"]) == float(loss.detach())
    assert float(m2["grad_norm"]) == float(s1["grad_norm"])
    assert int(aux["moe_dropped_slots"]) == int(m2["moe_dropped_slots"])


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "recurrentgemma-2b"])
def test_remat_recomputes_the_same_values(arch):
    """``remat="block"`` (each group under ``torch.utils.checkpoint``):
    the loss, every gradient and the MoE dropped slots equal the run that
    keeps its activations; the recompute counts no slot twice."""
    tc = dataclasses.replace(T_SMOKE[arch], compute_dtype=torch.float32)
    p = tlm.init_params(tc, 1, "cpu")
    b = _tb(_batches(J_SMOKE[arch], 1)[0])
    outs = []
    for remat in ("none", "block"):
        c = dataclasses.replace(tc, remat=remat)
        q = tblocks.tree_map(lambda x: x.detach().requires_grad_(True), p)
        loss, aux = tlm.loss_fn(c, q, b)
        grads = torch.autograd.grad(loss, topt.sorted_leaves(q), allow_unused=True)
        outs.append((loss, int(aux["moe_dropped_slots"]), grads))
    (l0, d0, g0), (l1, d1, g1) = outs
    assert torch.equal(l0, l1) and d0 == d1
    for a, c in zip(g0, g1):
        assert (a is None and c is None) or torch.equal(a, c)


def test_abstract_inputs_have_the_reference_trees():
    """``abstract_params`` / ``abstract_opt_state`` / ``abstract_inputs``
    (tensors on ``meta``) against the reference's ``jax.eval_shape`` trees:
    paths, shapes and dtypes."""

    def flat(tree):
        out = []
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            out.append((jax.tree_util.keystr(path), tuple(leaf.shape), str(leaf.dtype)))
        return sorted(out)

    for arch in ("qwen3-1.7b", "mamba2-130m", "whisper-base", "qwen2-vl-7b"):
        for shape in ("train_4k", "prefill_32k", "decode_32k"):
            _, _, _, want = jsteps.build_cell(arch, shape, smoke=True)
            cfg, sh, step, got = tsteps.build_cell(arch, shape, smoke=True)
            assert sh == tshapes.SHAPES[shape] and callable(step)
            assert all(t.device.type == "meta" for t in tblocks.tree_leaves(got)
                       if isinstance(t, torch.Tensor))
            got_np = jax.tree.map(
                lambda t: jax.ShapeDtypeStruct(tuple(t.shape), str(t.dtype).removeprefix("torch.")),
                got, is_leaf=lambda t: isinstance(t, torch.Tensor))
            assert flat(want) == flat(got_np), (arch, shape)
    assert jshapes.SHAPES["train_4k"].seq_len == 4096


# ---------------------------------------------------------------------------
# data and straggler monitor
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 3])
def test_batches_equal_the_reference(seed):
    ja = jdata.PackedBatcher(jdata.SyntheticSource(512, seed=seed), 4, 16)
    ta = tdata.PackedBatcher(tdata.SyntheticSource(512, seed=seed), 4, 16)
    for bj, bt in zip(iter(ja), [next(iter(ta)) for _ in range(12)]):
        for k in ("tokens", "labels"):
            assert bj[k].dtype == bt[k].dtype
            np.testing.assert_array_equal(bj[k], bt[k])
    jp, tp = jdata.make_pipeline(512, 2, 8, seed=seed), tdata.make_pipeline(512, 2, 8, seed=seed)
    for _ in range(6):
        bj, bt = next(jp), next(tp)
        np.testing.assert_array_equal(bj["tokens"], bt["tokens"])


def test_straggler_verdicts_equal_the_reference():
    rng = np.random.default_rng(0)
    times = np.abs(1.0 + 0.1 * rng.standard_normal(300))
    times[rng.integers(0, 300, 40)] *= 4  # spikes, some of them in runs
    times[100:104] *= 5
    jm, tm = jstrag.StragglerMonitor(), tstrag.StragglerMonitor()
    for k, t in enumerate(times):
        assert jm.observe(float(t)) == tm.observe(float(t)), k
        if jm.tripped:
            jm.reset()
            tm.reset()
        assert dataclasses.asdict(jm) == dataclasses.asdict(tm)


# ---------------------------------------------------------------------------
# the trainer and the drivers (TestTrainerE2E's three claims, on the port)
# ---------------------------------------------------------------------------


def _trainer(tmp_path, total_steps=6, fail_at=None, donate=False):
    """The reference's ``TestTrainerE2E._mk`` on the port: ``donate=False``
    as it passes."""
    cfg = T_SMOKE["qwen3-1.7b"]
    tcfg = TrainerConfig(
        total_steps=total_steps, ckpt_every=2, log_every=2, ckpt_dir=str(tmp_path),
        opt=topt.OptConfig(lr=1e-3, warmup_steps=2, total_steps=total_steps), donate=donate,
    )
    it = tdata.make_pipeline(cfg.vocab, batch=2, seq=16, seed=0)
    inj = (lambda s: s == fail_at) if fail_at is not None else None
    return Trainer(cfg, tcfg, "cpu", it, fail_injector=inj)


def test_trainer_loss_decreases(tmp_path):
    out = _trainer(tmp_path, total_steps=8).run()
    assert out["steps"] == 8 and len(out["step_seconds"]) == 8
    assert np.isfinite(out["losses"]).all()
    assert out["losses"][-1] < out["losses"][0]


def test_trainer_restart_resumes_from_checkpoint(tmp_path):
    _trainer(tmp_path, total_steps=5).run()
    out = _trainer(tmp_path, total_steps=7).run()
    assert out["steps"] == 3  # resumed at step 4 (the last checkpoint), ran 4..6


def test_trainer_failure_injection_remesh_path(tmp_path):
    t = _trainer(tmp_path, total_steps=6, fail_at=3)
    out = t.run()
    assert out["steps"] >= 3 and np.isfinite(out["final_loss"])
    assert (tmp_path / "step_00000003" / "COMMITTED").exists()  # the re-mesh's own save


def test_trainer_straggler_breaker_remesh_path(tmp_path):
    """A tripped straggler breaker re-meshes (checkpoint, rebuild, restore)
    and training goes on, the monitor reset."""
    t = _trainer(tmp_path, total_steps=5)
    real, seen = t.monitor.observe, []

    def observe(dt):  # the third step's time trips the breaker
        seen.append(dt)
        return "tripped" if len(seen) == 3 else real(dt)

    t.monitor.observe = observe
    out = t.run()
    assert out["steps"] == 5 and np.isfinite(out["losses"]).all() and len(seen) == 5
    assert (tmp_path / "step_00000002" / "COMMITTED").exists() and not t.monitor.tripped


def test_trainer_config_takes_the_reference_s_fields():
    """``TrainerConfig`` has the reference's fields and defaults (its
    ``ckpt_dir`` is the port's own temporary directory): ``donate=True``
    unless given."""
    want = {f.name: f.default for f in dataclasses.fields(jtrainer.TrainerConfig)}
    got = {f.name: f.default for f in dataclasses.fields(TrainerConfig)}
    assert want.keys() == got.keys()
    assert all(want[k] == got[k] for k in want if k not in ("ckpt_dir", "opt"))
    assert TrainerConfig().donate and not TrainerConfig(donate=False).donate


def test_trainer_losses_equal_with_and_without_donation(tmp_path):
    outs = {}
    for donate in (True, False):
        t = _trainer(tmp_path / str(donate), total_steps=4, donate=donate)
        outs[donate] = (t.run()["losses"], topt.sorted_leaves(t.state))
    np.testing.assert_array_equal(outs[True][0], outs[False][0])
    assert all(torch.equal(a, b) for a, b in zip(outs[True][1], outs[False][1], strict=True))


def test_undonated_step_leaves_the_tensors_handed_to_it():
    """``CompiledTrainStep(donate=False)`` trains copies taken at its build
    and leaves the caller's parameters and Adam state as they were; handed
    them again, it copies them in and repeats the first step. Donated, the
    same steps give the same values, written into the caller's tensors."""
    tc = dataclasses.replace(T_SMOKE["qwen3-1.7b"], compute_dtype=torch.float32)
    ocfg = topt.OptConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    bs = [_tb(b) for b in _batches(J_SMOKE["qwen3-1.7b"], 3)]
    p = tlm.init_params(tc, 0, "cpu")
    st = topt.init_opt_state(ocfg, p)
    before = [x.clone() for x in topt.sorted_leaves((p, st))]
    step = tsteps.CompiledTrainStep(tc, ocfg, donate=False)
    q, qs, m = step(p, st, bs[0])
    losses = [float(m["loss"])]
    for b in bs[1:]:
        q, qs, m = step(q, qs, b)
        losses.append(float(m["loss"]))
    assert all(torch.equal(a, b) for a, b in zip(before, topt.sorted_leaves((p, st))))
    assert q is not p and int(qs.step) == 3 and step.builds == 1
    again = step(p, st, bs[0])[2]  # the caller's tensors again: copied in, no new build
    assert float(again["loss"]) == losses[0] and step.builds == 1

    donated = tsteps.CompiledTrainStep(tc, ocfg)
    dp, ds = p, st
    for b, want in zip(bs, losses):
        dp, ds, dm = donated(dp, ds, b)
        assert dp is p and float(dm["loss"]) == want
    assert int(st.step) == 3  # written in place


def test_train_driver_smoke_on_cpu(tmp_path):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = ttrain.main(["--arch", "mamba2-130m", "--smoke", "--device", "cpu", "--steps", "4",
                           "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path),
                           "--ckpt-every", "2"])
    line = buf.getvalue().strip().splitlines()[-1]
    assert line.startswith("arch=mamba2-130m steps=4 first_loss=") and "final_loss=" in line
    assert out["steps"] == 4
    # --mesh is ported: a 2 x 1 mesh needs two ranks, and this process opens one
    with pytest.raises(ValueError, match="needs 2 devices, the process group has 1"):
        ttrain.main(["--arch", "qwen3-1.7b", "--mesh", "2x1", "--device", "cpu"])
    assert not torch.distributed.is_initialized()  # the driver closed its group


def test_train_driver_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default runs")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.main(["--arch", "qwen3-1.7b", "--smoke", "--steps", "1"])


@pytest.mark.parametrize("arch", ["mamba2-130m", "recurrentgemma-2b"])
def test_serve_driver_runs_the_new_families(arch):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tserve.main(["--arch", arch, "--smoke", "--device", "cpu", "--ticks", "40"])
    line = buf.getvalue().splitlines()[0]
    assert line.startswith(f"arch={arch} replicas=2 arrived=")
