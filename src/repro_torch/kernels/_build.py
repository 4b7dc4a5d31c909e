"""Build and load the hand-written Hopper kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` on its own into a shared library with a
plain C interface, which is loaded with ``ctypes``; no PyTorch header is
compiled. A library is built at first use and rebuilt when its source or
the flags change (the file name carries their hash). ``--fmad=false`` keeps
every multiply and add separately rounded, as PyTorch's own elementwise
kernels round them; ``--use_fast_math`` is never used.

Libraries go to ``build/kernels/`` at the root of the checkout. Nothing is
compiled when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NAMES = tuple(sorted(p.stem for p in CSRC.glob("*.cu")))  # every source
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}
_typed: Dict[str, set] = {}  # functions of each library whose argtypes are set


def nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{h}.so"


def build(names: Iterable[str] = NAMES) -> Dict[str, float]:
    """Compile every named kernel whose library is missing, one ``nvcc``
    per source, all started together. Returns the seconds each took (0.0
    for a library that was already built). Raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp,
            out,
        )
    seconds = {name: 0.0 for name in names}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return seconds


def load(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if needed.

    ``signatures`` maps each C function to its ``argtypes``; every function
    returns a C ``int``. Pointers and the stream are ``c_void_p`` (a bare
    Python int would be passed as a 32-bit int and cut).
    """
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(lib_path(name)))
        _loaded[name] = lib
        _typed[name] = set()
    if not signatures.keys() <= _typed[name]:  # a caller with functions not yet typed
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _typed[name] |= signatures.keys()
    return lib


def attrs(name: str, k: int) -> Dict[str, int]:
    """``cudaFuncGetAttributes`` of the ``k``-th ``__global__`` of
    ``csrc/<name>.cu``, through its ``<name>_attrs`` export (the order is the
    ``KERNELS`` tuple of the kernel's ``plan.py``)."""
    fn = f"{name}_attrs"
    lib = load(name, {fn: [ctypes.c_int, ctypes.c_void_p]})
    out = (ctypes.c_int * 3)()
    check(getattr(lib, fn)(k, out), fn)
    return {"static_smem": out[0], "registers": out[1], "max_threads": out[2]}


def check(err: int, name: str) -> None:
    """Raise on the ``cudaGetLastError()`` code a launch function returned."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def expect(x, dtype, shape, what: str) -> None:
    """Raise unless ``x`` is a contiguous CUDA tensor of this dtype and shape."""
    if not x.is_cuda or x.dtype != dtype or tuple(x.shape) != tuple(shape) or not x.is_contiguous():
        raise ValueError(
            f"{what}: want a contiguous CUDA {dtype} tensor of shape {tuple(shape)}, "
            f"got {x.dtype} {tuple(x.shape)} on {x.device}"
            f"{'' if x.is_contiguous() else ' (not contiguous)'}"
        )


def stream(x) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on the device of ``x``."""
    return ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)


def ptr(x) -> ctypes.c_void_p:
    return ctypes.c_void_p(x.data_ptr())
