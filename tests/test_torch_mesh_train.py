"""The mesh-aware trainer (``repro_torch.train.trainer.Trainer`` on a
``DeviceMesh``) and the train driver's ``--mesh``, on the CPU at smoke
width, against the port's one-device trainer and the JAX package.

The reference's own ``Trainer`` fails under its (1, 1) mesh (ROADMAP C), so
the mesh trainer is held to:

  * the port's one-device trainer: on a one-rank gloo (1, 1) mesh, losses
    and final parameters and optimizer state bit-equal, for every arch the
    one-device trainer runs (whisper-base fails in both packages: the
    driver feeds no frame embeddings);
  * live jitted JAX steps without a mesh, from the trainer's own initial
    parameters carried across by ``models.bridge``: losses within
    ``LOSS_RTOL`` (1e-6) and parameters within ``STEP_PARAM_LR_TOL`` (0.25
    lr), the bounds of ``tests/test_torch_train.py``;
  * on two gloo ranks (``spawn_ranks``), meshes (2, 1) and (1, 2): two
    trainer steps of qwen3-1.7b, olmoe-1b-7b and mamba2-130m (its SSD mixer
    a batch-local region) within those bounds of the one-device trainer
    (the sums of a sharded contraction reduce in another order: measured
    within 1.5e-7 of the loss, 0.03 lr of the parameters); on the same
    ranks olmoe-1b-7b's MoE layer gives the same output bit for bit with
    ``moe_ep_constraint`` (the dispatch buffer and expert output on
    "model") as without it;
  * a checkpoint written under (2, 1) restores under (1, 2) with every
    value equal.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from _torch_mesh_workers import B, OPT, S, host, remesh_round_trip, train_on_mesh, trainer
from _torch_parity import port_arch

from repro.configs import SMOKE as J_SMOKE
from repro.launch import steps as jsteps
from repro.train import data as jdata
from repro.train import optimizer as jopt
from repro_torch.configs import SMOKE as T_SMOKE
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import make_mesh
from repro_torch.parallel.local import spawn_ranks

LOSS_RTOL = 1e-6
STEP_PARAM_LR_TOL = 0.25
TRAIN_ARCHS = sorted(a for a in T_SMOKE if a != "whisper-base")
STEPS = 3


@pytest.fixture
def group1(tmp_path):
    """A one-rank gloo process group in this process (FileStore, no port)."""
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0, world_size=1
    )
    try:
        yield make_mesh((1, 1), ("data", "model"), "cpu")
    finally:
        dist.destroy_process_group()


def _run(arch, where, tmp, steps=STEPS, cfg=None):
    tr = trainer(arch, where, steps, str(tmp), cfg=cfg)
    out = tr.run()
    return out["losses"], host(dict(zip(("params", "opt"), tr.state)))


def _assert_state_equal(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _assert_within(want_losses, want: dict, got_losses, got: dict) -> None:
    np.testing.assert_allclose(got_losses, want_losses, rtol=LOSS_RTOL, atol=0)
    for k in want:
        if k.startswith("params/"):
            gap = np.abs(want[k].astype(np.float64) - got[k].astype(np.float64)).max()
            assert gap <= STEP_PARAM_LR_TOL * OPT.lr, (k, gap)


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_one_by_one_mesh_equals_one_device(group1, tmp_path, arch):
    want_losses, want = _run(arch, "cpu", tmp_path / "dev")
    got_losses, got = _run(arch, group1, tmp_path / "mesh")
    np.testing.assert_array_equal(got_losses, want_losses)
    _assert_state_equal(want, got)
    assert np.all(np.isfinite(got_losses))


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "olmoe-1b-7b", "mamba2-130m"])
def test_one_by_one_mesh_matches_jax(group1, tmp_path, arch):
    """The mesh trainer against jitted reference steps from the same
    initial parameters and the same batches, float32 compute."""
    jc = dataclasses.replace(J_SMOKE[arch], compute_dtype=jnp.dtype("float32"))
    tr = trainer(arch, group1, STEPS, str(tmp_path), cfg=port_arch(jc))
    p0 = host({"params": tr.init_state(0)[0]})
    got = tr.run()["losses"]
    final = host({"params": tr.state[0]})

    jp = jax.tree.map(jnp.asarray, _unprefix(p0))
    jo = jopt.OptConfig(**dataclasses.asdict(OPT))
    jstep = jax.jit(jsteps.make_train_step(jc, jo))
    js = jopt.init_opt_state(jo, jp)
    it = iter(jdata.make_pipeline(jc.vocab, B, S, seed=0))
    want = []
    for _ in range(STEPS):
        jp, js, m = jstep(jp, js, {k: jnp.asarray(v) for k, v in next(it).items()})
        want.append(float(m["loss"]))
    jfinal = {f"params/{k}": np.asarray(v) for k, v in _flat(jp).items()}
    _assert_within(np.asarray(want), jfinal, got, final)


def _unprefix(d: dict) -> dict:
    """``{"params/a/b": x}`` as the nested ``{"a": {"b": x}}``."""
    out: dict = {}
    for k, v in d.items():
        node = out
        *path, leaf = k.split("/")[1:]
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def _flat(tree, prefix="") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "olmoe-1b-7b", "mamba2-130m"])
def test_two_ranks_within_float32_bounds(tmp_path, arch):
    cfg = dataclasses.replace(T_SMOKE[arch], compute_dtype=torch.float32)
    want_losses, want = _run(arch, "cpu", tmp_path / "dev", steps=2, cfg=cfg)
    for shape in ((2, 1), (1, 2)):
        outs = spawn_ranks(train_on_mesh, 2,
                           (arch, shape, 2, str(tmp_path / f"m{shape}"), cfg), device="cpu")
        for o in outs:  # both ranks hold the same full values
            _assert_within(want_losses, want, o["losses"], o["state"])
            if cfg.moe is not None:
                np.testing.assert_array_equal(*o["moe"], err_msg=f"moe_ep_constraint {shape}")
        _assert_state_equal(outs[0]["state"], outs[1]["state"])


def test_checkpoint_restores_under_another_mesh(tmp_path):
    outs = spawn_ranks(remesh_round_trip, 2, ("qwen3-1.7b", str(tmp_path)), device="cpu")
    for o in outs:
        _assert_state_equal(o["before"], o["after"])
        assert o["step"] == 2 and o["mesh"] == (1, 2)
        # wq (G, d, H*D): d over "data" under (2, 1), H*D over "model" under (1, 2)
        (g, d, hd), after = o["local_shapes"]
        assert after == (g, 2 * d, hd // 2), o["local_shapes"]
    assert (tmp_path / "step_00000002" / "COMMITTED").exists()


def test_driver_mesh_one_by_one_equals_one_device(tmp_path, capsys):
    argv = ["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu", "--steps", "3",
            "--batch", "2", "--seq", "16", "--ckpt-every", "2"]
    one = ttrain.main(argv + ["--ckpt-dir", str(tmp_path / "a")])
    mesh = ttrain.main(argv + ["--ckpt-dir", str(tmp_path / "b"), "--mesh", "1x1"])
    np.testing.assert_array_equal(one["losses"], mesh["losses"])
    assert not dist.is_initialized()  # the driver closed the group it opened
    assert (tmp_path / "b" / "step_00000002" / "COMMITTED").exists()
    out = capsys.readouterr().out
    assert out.count("arch=qwen3-1.7b steps=3") == 2


def test_driver_restarts_under_a_mesh(tmp_path):
    argv = ["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu", "--batch", "2",
            "--seq", "16", "--ckpt-every", "2", "--ckpt-dir", str(tmp_path), "--mesh", "1x1"]
    ttrain.main(argv + ["--steps", "3"])
    out = ttrain.main(argv + ["--steps", "5"])
    assert out["steps"] == 3  # resumed at step 2, as the reference's restart does


def test_make_mesh_refuses_a_size_that_is_not_the_world(group1):
    with pytest.raises(ValueError, match="needs 2 devices, the process group has 1"):
        make_mesh((2, 1), ("data", "model"), "cpu")
