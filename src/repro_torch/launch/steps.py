"""Step builders + abstract input specs for every (arch x shape) cell: a port
of ``repro.launch.steps``.

``abstract_inputs(cfg, shape)`` returns stand-ins for everything a cell's
step consumes (params, optimizer state, batches, KV caches) as tensors on
``torch.device("meta")``: shapes and dtypes, no memory, the counterpart of
the reference's ``jax.eval_shape`` trees.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs import get, get_smoke
from repro_torch.configs.shapes import SHAPES, ShapeSpec
from repro_torch.models import lm, regions
from repro_torch.models.blocks import tree_flatten, tree_map
from repro_torch.models.common import ArchConfig
from repro_torch.train import optimizer as opt

DEFAULT_OPT = opt.OptConfig()
META = torch.device("meta")


# ---------------------------------------------------------------------------
# step builders
# ---------------------------------------------------------------------------


def make_train_step(cfg: ArchConfig, ocfg: opt.OptConfig = DEFAULT_OPT):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the loss and its gradient, then AdamW written into
    ``params`` and ``opt_state`` in place (the reference's jit donates
    those buffers). ``metrics`` holds ``loss``, ``grad_norm``, ``lr`` and
    ``moe_dropped_slots`` (tensors on the device).

    Every step runs under ``implicit_replication``: with DTensor
    parameters (a mesh), a plain tensor the model makes (positions, masks,
    RoPE tables) counts as replicated; with plain parameters it does
    nothing."""

    def _cast_once(p):
        if not cfg.cast_params_once:
            return p
        return tree_map(
            lambda x: x.to(cfg.compute_dtype)
            if (x.dtype == torch.float32 and x.ndim >= 2) else x,
            p,
        )

    def train_step(params, opt_state, batch):
        with torch.enable_grad(), implicit_replication():
            p = tree_map(lambda x: x.detach().requires_grad_(True), params)
            loss, aux = lm.loss_fn(cfg, _cast_once(p), batch)
            leaves = opt.sorted_leaves(p)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            by_leaf = {id(x): torch.zeros_like(x) if g is None else g
                       for x, g in zip(leaves, grads)}
            grads = tree_map(lambda x: by_leaf[id(x)], p)
            new_params, new_state, stats = opt.adamw_update_(ocfg, params, grads, opt_state)
        metrics = {"loss": loss.detach(), **stats}
        if "moe_dropped_slots" in aux:
            metrics["moe_dropped_slots"] = aux["moe_dropped_slots"]
        return new_params, new_state, metrics

    return train_step


class CompiledTrainStep:
    """:func:`make_train_step` compiled: the reference's ``jax.jit(step_fn,
    donate_argnums=(0, 1) if donate else ())`` (``Trainer._build``).

    ``step(params, opt_state, batch) -> (params, opt_state, metrics)``.
    The body is ``make_train_step``'s own (the loss, ``autograd.grad``,
    AdamW in place) over the state it was built for, a static copy of the
    batch and static outputs: ``metrics`` holds the same four tensors at
    every call (``loss``, ``grad_norm``, ``lr``, ``moe_dropped_slots``),
    overwritten by the next call.

    A build is keyed on the storage of the state's leaves and on the
    shapes of the state and the batch. A call with another key builds
    anew, as the reference re-jits in ``_build``: that call's step runs
    eagerly as the warm-up (on CUDA on the side stream of ``core.scan``,
    which makes the schedule's table and every lazy state), then, on CUDA,
    the cached blocks go back to the device and the body is captured as a
    CUDA graph (``thread_local`` mode, the graph kept for
    ``kernel_bench.graph_census``), which does not run it. Every
    later call copies its batch into the static one and replays the graph;
    on the CPU it runs the body. So the updates are the eager ones: one
    warm-up step a build, then replays. A capture or a replay that fails
    raises.

    ``donate=True`` runs the body over the caller's tensors, updated in
    place: handing over other tensors (a restore) builds anew.
    ``donate=False`` leaves the caller's tensors as they were: a build
    takes copies of them, the body updates the copies, and a later call
    with other tensors of the same shapes copies their values in. The
    state a call returns is the body's, so a caller that passes it back
    copies nothing.
    """

    def __init__(self, cfg: ArchConfig, ocfg: opt.OptConfig = DEFAULT_OPT, donate: bool = True):
        self.fn = make_train_step(cfg, ocfg)
        self.donate = donate
        self.state = None  # (params, opt_state) the body updates
        self.batch: Dict[str, torch.Tensor] = {}
        self.metrics: Dict[str, torch.Tensor] = {}
        self.key: tuple = ()
        self.graph = None
        self.builds = 0

    def __call__(self, params, opt_state, batch):
        state = (params, opt_state)
        key = (_storage(state), _shapes(state), _shapes(batch))
        if key != self.key:
            if self.donate or key[1:] != self.key[1:]:
                return self._build(state, batch)
            for dst, src in zip(_leaves(self.state), _leaves(state)):
                dst.copy_(src)
        for k, v in batch.items():
            self.batch[k].copy_(v)
        if self.graph is None:
            self._body()
        else:
            self.graph.replay()
        return (*self.state, dict(self.metrics))

    def _build(self, state, batch):
        from repro_torch.core.scan import _canonical, capture, on_side_stream

        self.graph = None  # the last build's graph and pool go first
        if not self.donate:
            state = tuple(tree_map(lambda x: None if x is None else x.clone(), t) for t in state)
        self.state = state
        self.batch = {k: v.clone() for k, v in batch.items()}
        self.metrics = {}
        self.key = (_storage(state), _shapes(state), _shapes(batch))
        self.builds += 1
        dev = _canonical(regions.shard(_leaves(state)[0]).device)
        if dev.type == "cuda":
            on_side_stream(self._body, dev)  # the warm-up: this call's step
            # the graph's pool holds the step's transient memory anew: give
            # the warm-up's cached blocks back first (qwen3-1.7b, 28 layers,
            # batch 2 x seq 4096 on an 80 GB H100: 74.5 GiB reserved
            # without it, 47.8 with it)
            torch.cuda.empty_cache()
            self.graph = capture(self._body, dev)
        else:
            self._body()
        return (*self.state, dict(self.metrics))

    def _body(self) -> None:
        """One step over the static state and batch; the metrics into the
        static outputs (the first run's outputs become them)."""
        _, _, m = self.fn(*self.state, self.batch)
        if not self.metrics:
            self.metrics = m
            return
        for k, v in m.items():
            self.metrics[k].copy_(v)


def _leaves(tree) -> list:
    """The leaves in JAX's flattening order (``None`` no leaf)."""
    return tree_flatten(tree)[1]


def _storage(tree) -> tuple:
    return tuple(regions.shard(x).data_ptr() for x in _leaves(tree))


def _shapes(tree) -> tuple:
    """The structure, shapes, dtypes and placements of a tree's leaves."""
    keys, leaves = tree_flatten(tree)
    return tuple((k, tuple(x.shape), x.dtype, getattr(x, "placements", None))
                 for k, x in zip(keys, leaves))


def make_prefill_step(cfg: ArchConfig):
    def prefill_step(params, tokens, caches, extras):
        with implicit_replication():
            return lm.prefill(
                cfg, params, tokens, caches, extras.get("pos3"), extras.get("enc_embeds"),
            )

    return prefill_step


def make_serve_step(cfg: ArchConfig):
    def serve_step(params, token, index, caches, extras):
        with implicit_replication():
            return lm.decode_step(
                cfg, params, token, index, caches, extras.get("pos3"), extras.get("enc_embeds"),
            )

    return serve_step


# ---------------------------------------------------------------------------
# abstract inputs
# ---------------------------------------------------------------------------


def abstract_params(cfg: ArchConfig):
    return lm.init_params(cfg, 0, META)


def abstract_opt_state(cfg: ArchConfig, ocfg: opt.OptConfig = DEFAULT_OPT):
    return opt.init_opt_state(ocfg, abstract_params(cfg))


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _extras(cfg: ArchConfig, B: int, S: int) -> Dict[str, Any]:
    ex: Dict[str, Any] = {}
    if cfg.enc_layers > 0:
        ex["enc_embeds"] = _sds((B, cfg.enc_seq, cfg.d_model), torch.float32)
    if cfg.mrope_sections is not None:
        ex["pos3"] = _sds((3, B, S), torch.int32)
    return ex


def abstract_inputs(
    cfg: ArchConfig, shape: ShapeSpec, ocfg: opt.OptConfig = DEFAULT_OPT
) -> Tuple[Any, ...]:
    """Abstract step arguments for this cell (matching the step builder)."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        batch = {
            "tokens": _sds((B, S), torch.int32),
            "labels": _sds((B, S), torch.int32),
            **_extras(cfg, B, S),
        }
        return (abstract_params(cfg), abstract_opt_state(cfg, ocfg), batch)
    if shape.kind == "prefill":
        caches = lm.init_cache(cfg, B, S, META)
        return (abstract_params(cfg), _sds((B, S), torch.int32), caches, _extras(cfg, B, S))
    if shape.kind == "decode":
        caches = lm.init_cache(cfg, B, S, META)
        return (
            abstract_params(cfg),
            _sds((B, 1), torch.int32),
            _sds((), torch.int32),
            caches,
            _extras(cfg, B, 1),
        )
    raise ValueError(shape.kind)


def build_cell(arch: str, shape_name: str, smoke: bool = False):
    """Returns (cfg, shape, step_fn, abstract_args)."""
    cfg = get_smoke(arch) if smoke else get(arch)
    shape = SHAPES[shape_name]
    if shape.kind == "train":
        step = make_train_step(cfg)
    elif shape.kind == "prefill":
        step = make_prefill_step(cfg)
    else:
        step = make_serve_step(cfg)
    return cfg, shape, step, abstract_inputs(cfg, shape)
