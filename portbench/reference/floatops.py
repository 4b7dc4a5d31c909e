"""float32 arithmetic rounded as the JAX package's jitted CPU program rounds it.

The baselines carry fractional decision budgets whose ``floor`` decides how
many tasks get a decision each tick, so one ulp can move a decision by a
tick. The reference runs them under ``jax.jit`` on the CPU, where XLA

  * turns a division by a constant into a multiply by its float32
    reciprocal (and folds chains of constant factors into one);
  * contracts a multiply feeding an add inside one fused loop into a fused
    multiply-add (LLVM's ``fp-contract=fast``);
  * computes ``exp`` and ``log`` with its own Cephes polynomials (with
    those contractions), not the C library's, and flushes subnormal
    results to zero.

This module rebuilds those roundings from IEEE operations only: float32
``+ - * /``, ``floor`` and bit moves, and a fused multiply-add emulated as a
float64 product and sum rounded once to float32 (exact for float32 inputs
but for a double rounding, at most once in about 2**29 values). Each is
correctly rounded on the CPU and on CUDA alike, so a CPU run and a CUDA run
agree bit for bit, and both equal the reference where it rounds this way.
Every function keeps float32 tensors in and out.
"""

from __future__ import annotations

import math
import struct

import numpy as np
import torch

F32 = torch.float32
TINY = float(np.finfo(np.float32).tiny)  # smallest normal float32


def _hex(bits: int) -> float:
    """A float32 constant written as LLVM prints it (the bits of the double)."""
    return float(np.array([bits], np.uint64).view(np.float64)[0])


def f32(x: float) -> float:
    """``x`` rounded to float32 (a host constant), by the C cast ``struct``
    packs with: round to nearest even; past float32's range, an infinity of
    its sign (``struct`` raises there), as ``np.float32`` gives."""
    try:
        return struct.unpack("<f", struct.pack("<f", x))[0]
    except OverflowError:
        return math.copysign(math.inf, x)


def recip(x: float) -> float:
    """The float32 reciprocal XLA folds a division by ``x`` into: the double
    quotient rounded once to float32 is the float32 quotient (double carries
    more than 2 * 24 + 2 bits); an infinity of its sign at zero."""
    d = f32(x)
    return math.copysign(math.inf, d) if d == 0 else f32(1.0 / d)


def fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """``a * b + c`` with one rounding to float32 (``b``, ``c``: tensors or
    float32-representable constants)."""
    f64 = torch.float64
    a = a.to(f64)
    b = b.to(f64) if isinstance(b, torch.Tensor) else b
    c = c.to(f64) if isinstance(c, torch.Tensor) else c
    return (a * b + c).to(F32)


# XLA CPU's float32 exp (Cephes expf, clamped input, 2**n built from bits)
_EXP_LO, _EXP_HI = _hex(0xC055F33340000000), _hex(0x4056333340000000)  # -87.8, 88.8
_LOG2E = _hex(0x3FF7154760000000)
_C1, _C2 = _hex(0x3FE6300000000000), _hex(0xBF2BD01060000000)  # ln 2 = C1 + C2
_EXP_P = (_hex(0x3F2A0D2CE0000000), _hex(0x3F56E879C0000000), _hex(0x3F81112100000000),
          _hex(0x3FA5553820000000), _hex(0x3FC5555540000000), 0.5)


def exp(x: torch.Tensor) -> torch.Tensor:
    """float32 ``exp`` as XLA's CPU backend computes it, subnormal results
    flushed to zero."""
    x = torch.clamp(x, _EXP_LO, _EXP_HI)
    n = torch.clamp(torch.floor(fma(x, _LOG2E, 0.5)), -127.0, 127.0)
    r = fma(n, -_C1, x)
    r = fma(n, -_C2, r)
    p = fma(r, _EXP_P[0], _EXP_P[1])
    for k in _EXP_P[2:]:
        p = fma(p, r, k)
    y = 1.0 + fma(p, r * r, r)
    out = y * ((n.to(torch.int32) + 127) << 23).view(F32)
    return torch.where(out < TINY, 0.0, out)


_SQRTHF = _hex(0x3FE6A09E60000000)
_LOG_P = (
    (_hex(0x3FB2043760000000), _hex(0xBFBD7A3700000000), _hex(0x3FBDE4A340000000)),
    (_hex(0xBFBFCBA9E0000000), _hex(0x3FC23D37E0000000), _hex(0xBFC555CA00000000)),
    (_hex(0x3FC999D580000000), _hex(0xBFCFFFFF80000000), _hex(0x3FD5555540000000)),
)


def log(y: torch.Tensor) -> torch.Tensor:
    """float32 natural ``log`` of positive finite ``y`` as XLA's CPU backend
    computes it (Cephes logf: three interleaved polynomials)."""
    bits = torch.clamp(y, min=TINY).view(torch.int32)
    e = ((bits >> 23) - 127).to(F32) + 1.0
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(F32)  # mantissa in [0.5, 1)
    low = m < _SQRTHF
    e = e - low.to(F32)
    x = (m - 1.0) + torch.where(low, m, 0.0)
    z = x * x
    x3 = z * x
    a, b, c = (fma(fma(x, p0, p1), x, p2) for p0, p1, p2 in _LOG_P)
    t = fma(fma(fma(a, x3, b), x3, c), x3, e * _C2)
    return fma(e, _C1, fma(z, -0.5, x) + t)


