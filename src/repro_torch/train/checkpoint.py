"""Checkpointing: save / restore with a manifest, an async writer, and the
restart / re-mesh support of the trainer. A port of
``repro.train.checkpoint`` with its on-disk format, so either package
restores the other's checkpoints:

  * ``<dir>/shards.npz``: one array a leaf, keyed by the leaf's path as the
    reference's ``_flatten`` writes it (``blocks.tree_flatten``: dict keys
    sorted, a NamedTuple field as ``.name``: ``params/embed``,
    ``opt/.step``, ``opt/.mu/embed``);
  * ``<dir>/manifest.json``: step, keys, shapes and dtypes;
  * ``<dir>/COMMITTED``: written last, the commit marker.

Tensors leave the device as numpy arrays (bfloat16 as ``ml_dtypes``'
bfloat16, as JAX hands it out); ``restore`` gives numpy arrays unless a
``placer(key, array)`` places them.
"""

from __future__ import annotations

import json
import threading
import zipfile
from pathlib import Path
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.models.blocks import tree_flatten as _flatten
from repro_torch.models.bridge import tensor_to_numpy


def _unflatten(tree: Any, leaves) -> Any:
    """``tree``'s structure with its leaves taken in order from ``leaves``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_unflatten(v, leaves) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_unflatten(v, leaves) for v in tree)
    return next(leaves)


def _host(leaf) -> np.ndarray:
    """``leaf`` as a numpy array that shares no memory with it: the trainer
    updates its tensors in place while a thread writes the checkpoint. A
    CUDA tensor's transfer is the copy; a CPU tensor's ``numpy()`` (or an
    array) is a view, copied here."""
    if isinstance(leaf, torch.Tensor) and leaf.device.type != "cpu":
        return tensor_to_numpy(leaf)
    return np.array(tensor_to_numpy(leaf) if isinstance(leaf, torch.Tensor) else leaf, copy=True)


def _to_host(tree: Any) -> Any:
    """Every leaf copied to the host as a numpy array."""
    return _unflatten(tree, iter(_host(x) for x in _flatten(tree)[1]))


def save(path: str | Path, step: int, tree: Any) -> None:
    """Synchronous checkpoint write (tensors copied to the host)."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    keys, leaves = _flatten(tree)
    arrays = {k: _host(leaf) for k, leaf in zip(keys, leaves)}
    np.savez(path / "shards.npz", **arrays)
    manifest = {
        "step": int(step),
        "keys": list(keys),
        "shapes": {k: list(a.shape) for k, a in arrays.items()},
        "dtypes": {k: str(a.dtype) for k, a in arrays.items()},
    }
    (path / "manifest.json").write_text(json.dumps(manifest, indent=2))
    (path / "COMMITTED").write_text(str(step))  # atomic-ish commit marker


def latest_step(root: str | Path) -> Optional[int]:
    root = Path(root)
    if not root.exists():
        return None
    steps = []
    for d in root.iterdir():
        if (d / "COMMITTED").exists():
            try:
                steps.append(int(d.name.split("_")[-1]))
            except ValueError:
                continue
    return max(steps) if steps else None


def restore(
    path: str | Path,
    abstract_tree: Any,
    placer: Optional[Callable[[str, np.ndarray], Any]] = None,
) -> Any:
    """Restore into the structure of ``abstract_tree`` (any tree of the same
    paths: tensors on ``meta``, arrays); ``placer(key, array)`` places each
    array (e.g. as a tensor on the trainer's device), identity if omitted."""
    path = Path(path)
    if not (path / "COMMITTED").exists():
        raise FileNotFoundError(f"no committed checkpoint at {path}")
    keys, _ = _flatten(abstract_tree)
    out = [placer(k, a) if placer else a for k, a in zip(keys, _read(path / "shards.npz", keys))]
    return _unflatten(abstract_tree, iter(out))


def _read(npz: Path, keys):
    """Each ``keys`` array of ``npz`` as a copy-on-write memory map of its
    bytes in the file (``np.savez`` stores them uncompressed): a
    full-width checkpoint restores at the page cache's speed, not through
    ``np.load``'s 256 KiB reads."""
    with zipfile.ZipFile(npz) as zf, open(npz, "rb") as f:
        for k in keys:
            info = zf.getinfo(f"{k}.npy")
            if info.compress_type != zipfile.ZIP_STORED:
                raise ValueError(f"{npz}: {k} is compressed; np.savez stores arrays")
            f.seek(info.header_offset)
            local = f.read(30)  # the member's local header: name and extra lengths at 26
            f.seek(info.header_offset + 30 + int.from_bytes(local[26:28], "little")
                   + int.from_bytes(local[28:30], "little"))
            version = np.lib.format.read_magic(f)
            read_header = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                           else np.lib.format.read_array_header_2_0)
            shape, fortran, dtype = read_header(f)
            if dtype.hasobject or not shape or 0 in shape:
                yield np.lib.format.read_array(zf.open(info))
            else:
                yield np.memmap(npz, dtype=dtype, mode="c", offset=f.tell(), shape=shape,
                                order="F" if fortran else "C")


class AsyncCheckpointer:
    """Overlaps checkpoint writes with training (one in flight at a time)."""

    def __init__(self, root: str | Path, keep: int = 3):
        self.root = Path(root)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save_async(self, step: int, tree: Any) -> None:
        self.wait()  # serialize with any in-flight write
        host_tree = _to_host(tree)

        def _write():
            try:
                save(self.root / f"step_{step:08d}", step, host_tree)
                self._gc()
            except BaseException as e:  # surfaced by wait()
                self._error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        dirs = sorted(d for d in self.root.iterdir() if (d / "COMMITTED").exists())
        for d in dirs[: -self.keep]:
            for f in d.iterdir():
                f.unlink()
            d.rmdir()

    def restore_latest(self, abstract_tree: Any, placer=None):
        step = latest_step(self.root)
        if step is None:
            return None, None
        tree = restore(self.root / f"step_{step:08d}", abstract_tree, placer)
        return step, tree
