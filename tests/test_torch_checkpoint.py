"""The port's checkpoints (``repro_torch.train.checkpoint``) against the JAX
package's, on the CPU: one on-disk format, read both ways.

  * A JAX ``save`` of ``{params, opt}`` after k jitted steps restores into
    the port, bit for bit, and the port's next step gives the JAX step's
    loss (within ``LOSS_RTOL``, 1e-6: float32 compute, the measured gap is
    under 1.6e-7) and its learning rate exactly.
  * A port checkpoint restores under ``repro.train.checkpoint.restore``
    into the reference's abstract trees, bit for bit, with the reference's
    manifest keys (``params/embed``, ``opt/.step``, ``opt/.mu/embed``).
  * The reference's own checkpoint tests, on the port: round trip, async
    writes with garbage collection, an uncommitted directory is invisible;
    and an async write keeps the values of its call when the CPU tensors
    are updated in place before the writer runs.
"""

from __future__ import annotations

import dataclasses
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import torch
from _torch_parity import jax_params, port_arch

from repro.configs import SMOKE as J_SMOKE
from repro.launch import steps as jsteps
from repro.train import checkpoint as jckpt
from repro.train import data as jdata
from repro.train import optimizer as jopt
from repro_torch.launch import steps as tsteps
from repro_torch.models import bridge
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import optimizer as topt

LOSS_RTOL = 1e-6


def _setup(arch="qwen3-1.7b", compress=False):
    jc = dataclasses.replace(J_SMOKE[arch], compute_dtype=jnp.float32)
    tc = port_arch(jc)
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=6, compress_grads=compress)
    it = iter(jdata.PackedBatcher(jdata.SyntheticSource(jc.vocab, seed=0), 2, 16))
    batches = [next(it) for _ in range(4)]
    return jc, tc, jopt.OptConfig(**kw), topt.OptConfig(**kw), batches


def _place(key, a):
    return bridge.tensor_from_numpy(a, "cpu")


def test_jax_checkpoint_restores_into_the_port(tmp_path):
    jc, tc, jo, to, batches = _setup(compress=True)
    jp, _ = jax_params(jc, seed=0)
    js = jopt.init_opt_state(jo, jp)
    jstep = jax.jit(jsteps.make_train_step(jc, jo))
    for b in batches[:2]:
        jp, js, _ = jstep(jp, js, {k: jnp.asarray(v) for k, v in b.items()})
    jckpt.save(tmp_path / "step_00000002", 2, {"params": jp, "opt": js})

    abstract = {"params": tsteps.abstract_params(tc), "opt": tsteps.abstract_opt_state(tc, to)}
    assert tckpt.latest_step(tmp_path) == 2
    tree = tckpt.restore(tmp_path / "step_00000002", abstract, placer=_place)
    tp, ts = tree["params"], tree["opt"]
    assert isinstance(ts, topt.AdamState) and int(ts.step) == 2
    want = jax.tree_util.tree_leaves({"params": jp, "opt": js})
    got = topt.sorted_leaves({"params": tp, "opt": ts})
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert np.shape(a) == tuple(b.shape)  # the step stays 0-d
        np.testing.assert_array_equal(np.asarray(a), b.numpy())

    b = batches[2]
    _, _, jm = jstep(jp, js, {k: jnp.asarray(v) for k, v in b.items()})
    _, _, tm = tsteps.make_train_step(tc, to)(
        tp, ts, {k: torch.from_numpy(v) for k, v in b.items()})
    assert abs(float(jm["loss"]) - float(tm["loss"])) <= LOSS_RTOL * abs(float(jm["loss"]))
    assert float(jm["lr"]) == float(tm["lr"])


def test_port_checkpoint_restores_under_the_reference(tmp_path):
    jc, tc, jo, to, batches = _setup()
    _, tp = jax_params(jc, seed=0)
    ts = topt.init_opt_state(to, tp)
    step = tsteps.make_train_step(tc, to)
    for b in batches[:2]:
        tp, ts, _ = step(tp, ts, {k: torch.from_numpy(v) for k, v in b.items()})
    tckpt.save(tmp_path / "step_00000002", 2, {"params": tp, "opt": ts})
    assert (tmp_path / "step_00000002" / "COMMITTED").read_text() == "2"

    abstract = {"params": jsteps.abstract_params(jc), "opt": jsteps.abstract_opt_state(jc, jo)}
    tree = jckpt.restore(tmp_path / "step_00000002", abstract)
    assert jckpt.latest_step(tmp_path) == 2
    for a, b in zip(jax.tree_util.tree_leaves(tree), topt.sorted_leaves({"params": tp, "opt": ts})):
        assert np.shape(a) == tuple(b.shape)
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    manifest = json.loads((tmp_path / "step_00000002" / "manifest.json").read_text())
    assert manifest["keys"] == jckpt._flatten(abstract)[0]
    assert "opt/.step" in manifest["keys"] and "opt/.mu/embed" in manifest["keys"]
    assert manifest["step"] == 2 and manifest["dtypes"]["opt/.step"] == "int32"


def test_opt_state_bridge_round_trips():
    jc, tc, jo, to, _ = _setup(compress=True)
    jp, _ = jax_params(jc, seed=0)
    js = jax.tree.map(np.asarray, jopt.init_opt_state(jo, jp),
                      is_leaf=lambda x: x is None)
    ts = bridge.opt_state_from_numpy(js, "cpu")
    assert isinstance(ts, topt.AdamState) and ts.err is not None
    back = bridge.opt_state_to_numpy(ts)
    for a, b in zip(jax.tree_util.tree_leaves(js), jax.tree_util.tree_leaves(tuple(back))):
        np.testing.assert_array_equal(a, b)


def test_roundtrip(tmp_path):
    tree = {"a": torch.arange(6).reshape(2, 3), "b": {"c": torch.ones(4)}}
    tckpt.save(tmp_path / "step_00000005", 5, tree)
    abstract = {"a": torch.empty((2, 3), device="meta"), "b": {"c": torch.empty(4, device="meta")}}
    out = tckpt.restore(tmp_path / "step_00000005", abstract)
    np.testing.assert_array_equal(out["a"], tree["a"].numpy())
    np.testing.assert_array_equal(out["b"]["c"], tree["b"]["c"].numpy())


def test_async_and_gc(tmp_path):
    acp = tckpt.AsyncCheckpointer(tmp_path, keep=2)
    w = torch.zeros(3)
    for step in (1, 2, 3):
        w.fill_(float(step))  # an in-place update after the call: the write keeps the copy
        acp.save_async(step, {"w": w})
    acp.wait()
    assert tckpt.latest_step(tmp_path) == 3
    committed = [d for d in tmp_path.iterdir() if (d / "COMMITTED").exists()]
    assert len(committed) == 2  # gc kept the last two
    step, tree = acp.restore_latest({"w": torch.empty(3, device="meta")})
    assert step == 3 and tree["w"].tolist() == [3.0, 3.0, 3.0]


def test_async_write_keeps_the_values_of_its_call(tmp_path, monkeypatch):
    """The trainer's next step updates its CPU tensors in place while the
    writer thread runs: the checkpoint holds the values at ``save_async``.
    The writer is held until the update is done, so the order is fixed."""
    go = threading.Event()
    save = tckpt.save
    monkeypatch.setattr(tckpt, "save", lambda *a: (go.wait(), save(*a)))
    tree = {"params": {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
                       "h": torch.ones(4)},
            "opt": topt.AdamState(step=torch.tensor(7, dtype=torch.int32),
                                  mu={"w": torch.full((2, 3), 0.5)}, nu={"w": torch.zeros(2, 3)},
                                  err=None)}
    want = [x.clone() for x in topt.sorted_leaves(tree)]
    acp = tckpt.AsyncCheckpointer(tmp_path)
    acp.save_async(7, tree)
    for x in topt.sorted_leaves(tree):
        x.add_(1)  # the next step's in-place update
    go.set()
    acp.wait()
    meta = lambda x: torch.empty_like(x, device="meta")  # noqa: E731
    abstract = {"params": {k: meta(v) for k, v in tree["params"].items()},
                "opt": topt.AdamState(step=meta(tree["opt"].step), mu={"w": meta(want[0])},
                                      nu={"w": meta(want[0])}, err=None)}
    step, got = acp.restore_latest(abstract, placer=_place)
    assert step == 7
    for a, b in zip(want, topt.sorted_leaves(got)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_uncommitted_is_invisible(tmp_path):
    d = tmp_path / "step_00000009"
    d.mkdir()
    (d / "manifest.json").write_text("{}")  # no COMMITTED marker
    assert tckpt.latest_step(tmp_path) is None
    assert tckpt.AsyncCheckpointer(tmp_path).restore_latest({}) == (None, None)
