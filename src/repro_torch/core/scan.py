"""The compiled run: ``scan(step, state, draws, num_ticks)``.

The port's counterpart of the reference's ``jax.jit(lambda s: lax.scan(step,
s, None, length=T))`` (``repro.core.engine``'s ``_runner`` and
``_batch_runner``, each baseline's ``run``). On a CUDA device one tick is
captured once as a ``torch.cuda.CUDAGraph`` and replayed once a tick: after
the capture the host launches one graph a tick. On the CPU the same tick
body runs in a plain loop. There is no switch: the device of the state
decides, and a capture or a replay that fails raises.

The tick is an in-place body over static buffers (:class:`Compiled`):

* a buffer for each leaf of the state (a NamedTuple, nested ones too), a
  ring of :data:`RING` rows for the per-tick series, and the tick counter
  ``t``, an int32 on the device that the draws read in place of a Python
  tick;
* the body rebuilds the state from its buffers, runs ``step(state,
  draws)``, copies each leaf of the new state that is not its buffer back
  into it, writes the tick's series row into ring row ``t % RING`` and adds
  one to ``t``.

The draws reach the body one of two ways:

* sampled inside the tick (:class:`Sampled`): a provider that samples on
  the state's device (``TorchDraws``, ``TorchBaselineDraws``, or a
  ``BatchDraws`` of them) draws through its ``draw(t, gen, tables)`` from a
  generator the compiled tick owns, one a seed, registered with the graph,
  and from copies of its tables. Before a run each generator takes its
  provider's state, after it the provider takes the generator's: a run
  draws what the eager loop ``draws.tick(t)`` draws and leaves the provider
  where that loop would;
* filled from the host (:class:`Filled`): any other provider (values
  recorded beforehand, a generator on another device) hands tick ``t``'s
  values with ``draws.tick(t)``, copied into static buffers before each
  tick.

A run copies the caller's state into the buffers first and returns copies of
them: a second run of the same compiled tick leaves the first one's result
alone.

Spans (``core.spans``), a call's, never a replay's: ``scan.run`` around a
call, with ``scan.lookup`` (the key and the cache), ``scan.capture`` (a
miss: the warm-up tick, the capture, the instantiation), ``scan.load``
(the state copied in, the draws loaded), ``scan.replays`` (the loop) and
``scan.unload`` (the ring copied out, the draws stored, the state's copies).
While a recording is open, the counter ``scan.launch_ns`` sums the host ns
spent inside ``graph.replay()``. The body's own spans, ``scan.draws`` and
``scan.copyback``, run where the tick's do: at the capture. The capture
maps them (:attr:`Compiled.stages`): each kernel, memcpy and memset node
of the graph, in order, with the path of the innermost span that enqueued
it.
"""

from __future__ import annotations

import ctypes
import functools
import time
import weakref
from contextlib import contextmanager
from typing import Any, List, Optional, Tuple

import torch
import torch.utils._pytree as pytree

from repro_torch.core import spans
from repro_torch.core.draws import BatchDraws, TorchDraws
from repro_torch.core.spans import span
from repro_torch.kernels.utility_topk import ops as _topk

RING = 256  # rows of the series ring: one copy out of it every RING ticks

_watchers: list = []  # the lists of watching() blocks now open


@contextmanager
def watching():
    """Collect, into the list it yields, a ``(compiled, replays)`` pair for
    each run of a compiled tick inside the block: the :class:`Compiled`
    (its ``graph`` is None on the CPU) and the graph replays of that run."""
    runs: list = []
    _watchers.append(runs)
    try:
        yield runs
    finally:
        _watchers.remove(runs)


def _canonical(dev: torch.device) -> torch.device:
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


@functools.lru_cache(maxsize=None)
def _side_stream(device: torch.device) -> torch.cuda.Stream:
    """The stream every warm-up and capture on ``device`` runs on: one a
    device, so the eager warm-ups share one count accumulator region."""
    return torch.cuda.Stream(device=device)


def on_side_stream(fn, device: torch.device) -> None:
    """``fn()`` on ``device``'s side stream, after the work queued on the
    current stream and before the work queued on it later (a warm-up
    before a capture)."""
    side = _side_stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(device).wait_stream(side)


def capture(body, device: torch.device, generators=()) -> torch.cuda.CUDAGraph:
    """``body()`` captured as a CUDA graph on ``device``'s side stream, in
    ``thread_local`` mode (another thread's CUDA calls, such as NCCL's
    watchdog's, do not break it), ``generators`` registered with it; the
    graph kept (``keep_graph=True``, so ``kernel_bench.graph_census`` can
    read its nodes) and instantiated. Warm ``body`` up first (lazy
    initializations, NCCL's communicator): :func:`on_side_stream`. A
    capture that fails raises."""
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    for gen in generators:
        graph.register_generator_state(gen)

    def captured():
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            body()
        finally:
            graph.capture_end()

    on_side_stream(captured, device)
    graph.instantiate()
    return graph


# CUgraphNodeType -> the kinds a stage map lists (any other node is "other")
_NODE_KINDS = {0: "kernel", 1: "memcpy", 2: "memset"}
_CAPTURE_ACTIVE = 1  # CU_STREAM_CAPTURE_STATUS_ACTIVE


@functools.lru_cache(maxsize=None)
def _libcuda() -> ctypes.CDLL:
    """``libcuda``, with the signatures this module calls (the unsuffixed
    graph calls and ``cuStreamGetCaptureInfo_v2`` keep their CUDA 12 form
    in every later CUDA release)."""
    cu = ctypes.CDLL("libcuda.so.1")
    vp, sz = ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t)
    cu.cuStreamGetCaptureInfo_v2.argtypes = [
        vp, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(vp),
        ctypes.POINTER(ctypes.POINTER(vp)), sz]
    cu.cuGraphGetNodes.argtypes = [vp, ctypes.POINTER(vp), sz]
    cu.cuGraphGetEdges.argtypes = [vp, ctypes.POINTER(vp), ctypes.POINTER(vp), sz]
    cu.cuGraphNodeGetType.argtypes = [vp, ctypes.POINTER(ctypes.c_int)]
    for fn in (cu.cuStreamGetCaptureInfo_v2, cu.cuGraphGetNodes, cu.cuGraphGetEdges,
               cu.cuGraphNodeGetType):
        fn.restype = ctypes.c_int
    return cu


def capture_position() -> int:
    """The node the next operation captured on the current stream will
    depend on (0 before the first), from ``cuStreamGetCaptureInfo``.
    Raises ``RuntimeError`` where it cannot be read or is not one node."""
    try:
        cu = _libcuda()
    except (OSError, AttributeError) as e:
        raise RuntimeError(f"libcuda: {e}") from None
    status, cid, graph = ctypes.c_int(0), ctypes.c_uint64(0), ctypes.c_void_p()
    deps, n = ctypes.POINTER(ctypes.c_void_p)(), ctypes.c_size_t(0)
    err = cu.cuStreamGetCaptureInfo_v2(
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream), ctypes.byref(status),
        ctypes.byref(cid), ctypes.byref(graph), ctypes.byref(deps), ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"cuStreamGetCaptureInfo_v2 returned CUresult {err}")
    if status.value != _CAPTURE_ACTIVE:
        raise RuntimeError("the current stream is not capturing")
    if n.value > 1:
        raise RuntimeError(f"the next captured operation depends on {n.value} nodes: "
                           f"the graph is not a chain")
    return (deps[0] or 0) if n.value else 0


def graph_chain(graph: torch.cuda.CUDAGraph) -> List[Tuple[int, str]]:
    """The nodes of a kept graph in order, ``(handle, kind)``, from its one
    root along its edges. Raises ``RuntimeError`` where the graph is not a
    chain."""
    try:
        cu = _libcuda()
    except (OSError, AttributeError) as e:
        raise RuntimeError(f"libcuda: {e}") from None
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n, m = ctypes.c_size_t(0), ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(raw, None, ctypes.byref(n)) or cu.cuGraphGetEdges(
            raw, None, None, ctypes.byref(m)):
        raise RuntimeError("cuGraphGetNodes / cuGraphGetEdges failed")
    nodes = (ctypes.c_void_p * n.value)()
    src, dst = (ctypes.c_void_p * m.value)(), (ctypes.c_void_p * m.value)()
    if cu.cuGraphGetNodes(raw, nodes, ctypes.byref(n)) or cu.cuGraphGetEdges(
            raw, src, dst, ctypes.byref(m)):
        raise RuntimeError("cuGraphGetNodes / cuGraphGetEdges failed")
    after, heads = {}, set()
    for a, b in zip(src, dst):
        if a in after or b in heads:
            raise RuntimeError("a node of the graph has two edges in or out: not a chain")
        after[a] = b
        heads.add(b)
    roots = [x for x in nodes if x not in heads]
    if len(roots) != 1:
        raise RuntimeError(f"the graph has {len(roots)} roots: not a chain")
    chain, node = [], roots[0]
    while node is not None:
        t = ctypes.c_int(-1)
        cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(t))
        chain.append((node, _NODE_KINDS.get(t.value, "other")))
        node = after.get(node)
    if len(chain) != n.value:
        raise RuntimeError(f"the chain from the root holds {len(chain)} of {n.value} nodes")
    return chain


class Sampled:
    """Draws sampled inside the tick from the tick counter: ``providers``
    (one, or a seed each, stacked) give ``draw(t, gen, tables)``; the
    compiled tick owns a generator and a copy of the tables of each."""

    def __init__(self, providers, stacked: bool):
        self.templates = list(providers)
        self.stacked = stacked
        self.gens = [torch.Generator(device=p.gdev) for p in providers]
        self.tables = [type(p.tables)(*(x.clone() for x in p.tables)) for p in providers]

    @staticmethod
    def key(providers, stacked: bool) -> tuple:
        return ("sampled", stacked, tuple(p.signature() for p in providers))

    def load(self, providers) -> None:
        """Before a run: each provider's tables and generator state."""
        for gen, tab, p in zip(self.gens, self.tables, providers):
            for dst, src in zip(tab, p.tables):
                dst.copy_(src)
            gen.set_state(p.gen.get_state())

    def store(self, providers) -> None:
        """After a run: each provider takes its generator's state."""
        for gen, p in zip(self.gens, providers):
            p.gen.set_state(gen.get_state())

    def put(self, draws, t: int, first) -> None:
        """Nothing to do before a tick: the tick samples."""

    def states(self) -> list:
        return [gen.get_state() for gen in self.gens]

    def restore(self, states) -> None:
        for gen, st in zip(self.gens, states):
            gen.set_state(st)

    def draws(self, t: torch.Tensor):
        ds = [p.draw(t, gen, tab)
              for p, gen, tab in zip(self.templates, self.gens, self.tables)]
        return BatchDraws.stack(ds) if self.stacked else ds[0]


class Filled:
    """Draws filled from the host: static buffers shaped as ``first`` (tick
    0's draws), which :meth:`put` fills with each tick's values."""

    def __init__(self, first, device: torch.device):
        leaves, self.spec = pytree.tree_flatten(first)
        self.bufs = [None if x is None else x.to(device, copy=True) for x in leaves]
        self.gens: list = []

    @staticmethod
    def key(first) -> tuple:
        leaves, spec = pytree.tree_flatten(first)
        return ("filled", spec, _shapes(leaves))

    def load(self, providers) -> None:
        """Nothing to load: each tick's values come with :meth:`put`."""

    def store(self, providers) -> None:
        """Nothing to give back."""

    def put(self, draws, t: int, first) -> None:
        """Tick ``t``'s values (``first`` for tick 0) into the buffers."""
        d = first if t == 0 else draws.tick(t)
        leaves, spec = pytree.tree_flatten(d)
        if spec != self.spec:
            raise ValueError(f"tick {t}'s draws change their fields: {spec} != {self.spec}")
        for buf, x in zip(self.bufs, leaves):
            if buf is not None:
                buf.copy_(x, non_blocking=True)

    def states(self) -> list:
        return []

    def restore(self, states) -> None:
        """No generator to put back."""

    def draws(self, t: torch.Tensor):
        return pytree.tree_unflatten(self.bufs, self.spec)


def _copy(dst, src) -> None:
    """``dst[i].copy_(src[i])`` for all i: one ``_foreach_copy_`` a dtype,
    a few kernels in place of a copy a leaf."""
    groups: dict = {}
    for d, x in zip(dst, src):
        ds, xs = groups.setdefault(d.dtype, ([], []))
        ds.append(d)
        xs.append(x)
    for ds, xs in groups.values():
        torch._foreach_copy_(ds, xs)


def _shapes(leaves) -> tuple:
    return tuple(None if x is None else (tuple(x.shape), x.dtype) for x in leaves)


class Compiled:
    """One tick of ``step`` as an in-place body over static buffers shaped
    as ``state``, its draws from ``feed``; on CUDA the body captured once in
    ``graph`` (the CUDA graph is kept, so its nodes can be read) and replayed
    by :meth:`run`, on the CPU called by it.

    ``stages``: each kernel, memcpy and memset node of ``graph`` in chain
    order as ``(kind, path)``, ``path`` the innermost span that enqueued it
    (``core.spans``: e.g. ``tick.admission/da.address/
    hotpath.utility_topk_address``). None where the graph is not a chain,
    or a position could not be read, or on the CPU; ``stages_fault`` then
    says why. Building it never fails the capture."""

    def __init__(self, step, state, feed):
        leaves, self.spec = pytree.tree_flatten(state)
        self.shapes = _shapes(leaves)
        self.device = leaves[0].device
        self.bufs = [x.clone() for x in leaves]
        self.step, self.feed = step, feed
        self.t = torch.zeros((), dtype=torch.int32, device=self.device)
        self.ring = None  # made by the first tick: the warm-up on CUDA, the run's first on the CPU
        self.graph = None
        self.stages: Optional[list] = None
        self.stages_fault: Optional[str] = "the CPU runs the body: no graph"
        if self.device.type == "cuda":
            self._capture(feed.states())

    def _capture(self, saved) -> None:
        """Warm up on the side stream (one tick on the buffers, which every
        run overwrites; the generators put back), then capture one tick on
        it, its stage map beside it. The address kernel's accumulator
        regions taken by the capture are given back when this object goes."""
        with span("scan.capture"):
            on_side_stream(self._body, self.device)
            self.feed.restore(saved)
            stage_map = spans.StageMap(capture_position)
            with _topk.owned_regions() as regions, spans.mapping(stage_map):
                weakref.finalize(self, _topk.release, regions)
                self.graph = capture(self._body, self.device, self.feed.gens)
            moved = [i for i, (a, b) in enumerate(zip(saved, self.feed.states()))
                     if not torch.equal(a, b)]
            if moved:
                raise RuntimeError(f"the capture moved generators {moved} of the tick's draws")
            try:
                chain = graph_chain(self.graph)
            except RuntimeError as e:
                self.stages, self.stages_fault = None, str(e)
            else:
                self.stages, self.stages_fault = stage_map.resolve(chain)

    def _body(self) -> None:
        s = pytree.tree_unflatten(self.bufs, self.spec)
        with span("scan.draws"):
            d = self.feed.draws(self.t)
        new, y = self.step(s, d)
        leaves, spec = pytree.tree_flatten(new)
        if spec != self.spec or _shapes(leaves) != self.shapes:
            raise ValueError("the step changed the state's structure, shapes or dtypes")
        with span("scan.copyback"):
            held = {b.untyped_storage().data_ptr() for b in self.bufs if b.numel()}
            dst, src = [], []
            for buf, x in zip(self.bufs, leaves):
                if x is buf:
                    continue
                if x.numel() and x.untyped_storage().data_ptr() in held:
                    x = x.clone()  # a view of a buffer that this copy-back may overwrite
                dst.append(buf)
                src.append(x)
            _copy(dst, src)
            if self.ring is None:
                self.ring = y.new_zeros((RING, *y.shape))
            self.ring.index_put_(((self.t % RING).long().view(1),), y.unsqueeze(0))
            self.t.add_(1)

    def run(self, state, draws, num_ticks: int, first=None) -> Tuple[Any, torch.Tensor]:
        """``num_ticks`` ticks from ``state`` with ``draws``: the final state
        (copies) and the (num_ticks, *row) series. ``first`` is tick 0's
        draws of a host-filled feed, already drawn."""
        with span("scan.load"):
            leaves, spec = pytree.tree_flatten(state)
            if spec != self.spec or _shapes(leaves) != self.shapes:
                raise ValueError("state does not match the compiled tick's")
            providers = _providers(draws)
            _copy(self.bufs, leaves)
            self.t.zero_()
            self.feed.load(providers)
        with span("scan.replays"):
            out = self._replays(draws, num_ticks, first)
        with span("scan.unload"):
            lo = (num_ticks - 1) - (num_ticks - 1) % RING
            out[lo:].copy_(self.ring[: num_ticks - lo])
            self.feed.store(providers)
            for runs in _watchers:
                runs.append((self, num_ticks if self.graph is not None else 0))
            return pytree.tree_unflatten([b.clone() for b in self.bufs], self.spec), out

    def _replays(self, draws, num_ticks: int, first) -> torch.Tensor:
        """The ticks, each a replay (the body on the CPU); every full ring
        but the last copied out. While a recording is open, the host ns
        inside ``graph.replay()`` go to the counter ``scan.launch_ns``."""
        tick = self._body if self.graph is None else self.graph.replay
        timed = self.graph is not None and spans.recording_open()
        launch_ns = 0
        out = None
        for i in range(num_ticks):
            self.feed.put(draws, i, first)
            if timed:
                t0 = time.perf_counter_ns()
                tick()
                launch_ns += time.perf_counter_ns() - t0
            else:
                tick()
            if out is None:
                out = self.ring.new_empty((num_ticks, *self.ring.shape[1:]))
            if (i + 1) % RING == 0 and i + 1 < num_ticks:
                out[i + 1 - RING:i + 1].copy_(self.ring)
        if timed:
            spans.count("scan.launch_ns", launch_ns)
        return out


def _providers(draws) -> list:
    return list(draws.providers) if isinstance(draws, BatchDraws) else [draws]


def _samples_on(p, device: torch.device) -> bool:
    """Whether provider ``p`` samples on ``device`` and hands its draws
    there: then the tick samples (:class:`Sampled`)."""
    return (isinstance(p, TorchDraws) and _canonical(p.gdev) == device
            and _canonical(p.device) == device)


def scan(step, state, draws, num_ticks: int, cache: dict | None = None,
         key: tuple = ()) -> Tuple[Any, torch.Tensor]:
    """Run ``num_ticks`` (at least 1) ticks of ``step(state, draws) ->
    (state, row)`` from ``state``; ``draws.tick(t)``'s values, t = 0 to
    ``num_ticks - 1``, are each tick's. Returns the final state (the
    caller's own copy) and the (num_ticks, *row.shape) series, both still on
    the device.

    ``cache`` keeps the compiled tick under ``key`` (what ``step`` depends
    on: the config, the scenario, B), the state's structure and shapes and
    the kind of draws (their providers' signatures, or the shapes of
    host-filled values); a later call with an equal key replays it, and
    the ``step`` it was given is not read. Without ``cache`` the compiled
    tick lives for this call only."""
    if num_ticks < 1:
        raise ValueError(f"scan needs at least one tick, got {num_ticks}")
    with span("scan.run"):
        with span("scan.lookup"):
            leaves, spec = pytree.tree_flatten(state)
            device = _canonical(leaves[0].device)
            providers = _providers(draws)
            stacked = isinstance(draws, BatchDraws)
            first = None
            if all(_samples_on(p, device) for p in providers):
                for p in providers:
                    p.cover(num_ticks)
                feed_key = Sampled.key(providers, stacked)
            else:
                first = draws.tick(0)
                feed_key = Filled.key(first)
            full = (key, spec, _shapes(leaves), feed_key)
            compiled = cache.get(full) if cache is not None else None
        if compiled is None:
            feed = Sampled(providers, stacked) if first is None else Filled(first, device)
            compiled = Compiled(step, state, feed)
            if cache is not None:
                cache[full] = compiled
        return compiled.run(state, draws, num_ticks, first)
