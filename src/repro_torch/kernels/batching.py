"""The seed axis of the tick's five kernels, under ``torch.func.vmap``.

The lockstep engine (``core.engine``: ``simulate_batch``) runs the tick
under ``torch.func.vmap`` over a leading seed axis, as the JAX package's
``run_batch`` runs ``jax.vmap`` over its scan. ``vmap`` has no rule for a
launch through ``ctypes``, so each of the five entries the flat tick calls
is a ``torch.library.custom_op`` (``repro_torch::<entry>``):

  * its kernel, on the CPU and on CUDA, is the entry's wrapper, which takes
    the plain version for a CPU tensor and launches the hand-written kernel
    for a CUDA one;
  * its fake (meta) kernel gives the outputs' shapes;
  * its batching rule (``register_vmap``) calls the same wrapper ONCE for
    all seeds, every tensor with the seed axis first: the entry's plan then
    has a seed axis (``LaunchPlan.seeds``), so on CUDA it is one launch of
    the kernel with a seed axis in its grid (as ``vmap`` over a
    ``pallas_call`` adds a grid axis), on the CPU the plain version seed by
    seed (:func:`per_seed`).

Outside ``vmap`` the op is the wrapper on one seed's tensors. Either way the
wrapper's launch counter rises by one a call. Nothing here runs when the
module is imported but the registrations.
"""

from __future__ import annotations

import sys
from typing import Callable, Sequence

import torch

__all__ = ["dispatch", "per_seed", "register_batching", "seeds_first"]


def seeds_first(batch: int, in_dims: Sequence, args: Sequence) -> list:
    """``args`` with the seed axis first and contiguous, as an entry takes
    them: a mapped tensor has its axis moved to 0; a tensor ``vmap``
    does not map (every seed's the same) is broadcast to ``batch`` rows, a
    copy; ``None`` and non-tensors are kept. ``in_dims`` may be shorter
    than ``args`` (trailing ``None`` arguments)."""
    dims = tuple(in_dims) + (None,) * (len(args) - len(in_dims))
    out = []
    for a, d in zip(args, dims):
        if not isinstance(a, torch.Tensor):
            out.append(a)
        elif d is None:
            out.append(a.expand((batch,) + tuple(a.shape)).contiguous())
        else:
            out.append(a.movedim(d, 0).contiguous())
    return out


def per_seed(fn: Callable) -> Callable:
    """The plain version of a call with a seed axis: the plain version ``fn``
    applied seed by seed (the leading axis of every tensor argument),
    its outputs stacked along a new leading axis."""

    def batched(*args, **kw):
        B = next(a.shape[0] for a in args if isinstance(a, torch.Tensor))
        outs = [fn(*(a[i] if isinstance(a, torch.Tensor) else a for a in args), **kw)
                for i in range(B)]
        if isinstance(outs[0], torch.Tensor):
            return torch.stack(outs)
        return tuple(torch.stack(o) for o in zip(*outs))

    batched.__name__ = f"{fn.__name__}_per_seed"
    batched.__doc__ = f"``{fn.__name__}`` seed by seed, stacked."
    return batched


def dispatch(wrapper: Callable, plan, launch: Callable, ref: Callable, *args, **kw):
    """One call of an entry whose ``plan`` (its plan builder's, for these
    ``args``) says whether they carry a leading seed axis. CUDA tensors:
    ``launch(plan, outs, *args, **kw)`` into new outputs, counted on
    ``wrapper.launches``; a plan's one output is returned alone, several as
    a tuple. CPU tensors: the plain version ``ref``, seed by seed
    (:func:`per_seed`) when the plan has a seed axis."""
    if not args[0].is_cuda:
        return (per_seed(ref) if plan.seeds else ref)(*args, **kw)
    outs = plan.new_outputs(args[0].device)
    launch(plan, outs, *args, **kw)
    wrapper.launches += 1
    return outs[0] if len(outs) == 1 else tuple(outs)


def register_batching(op, wrapper: Callable) -> None:
    """Give the custom op ``op`` its batching rule: every tensor argument
    with the seed axis first (:func:`seeds_first`), then ONE call of the
    entry's ``wrapper`` (looked up on its module at each call, as a
    recording patch replaces it), its outputs mapped at 0."""
    module, name = sys.modules[wrapper.__module__], wrapper.__name__

    def rule(info, in_dims, *args, **kw):
        outs = getattr(module, name)(*seeds_first(info.batch_size, in_dims, args), **kw)
        n = 1 if isinstance(outs, torch.Tensor) else len(outs)
        return outs, (0,) * n if n > 1 else 0

    torch.library.register_vmap(op, rule)
