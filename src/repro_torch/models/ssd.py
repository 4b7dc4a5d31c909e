"""Mamba-2 SSD block (state-space duality, arXiv:2405.21060): a port of
``repro.models.ssd``.

Chunked SSD: within a chunk of length L the sequence mixing is computed in
its quadratic "attention" dual form (einsums over L x L masks); across
chunks a diagonal linear recurrence carries the (H, P, N) state, a Python
loop over the S / L chunks where the reference scans.

Layer structure follows mamba2: in_proj -> (z, x, B, C, dt); short depthwise
conv over (x, B, C); scalar-per-head A; SiLU gating by z; out_proj.

The three-operand einsums contract in the reference's order (XLA's
``dot_general`` sequence for ``jnp.einsum``): the chunk states as
``(decay_tail * x)`` against ``B``, the inter-chunk output as ``(C . h_in)``
times ``exp(a_cum)``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import common as cm
from repro_torch.models.common import ArchConfig, Params


class SSDState(NamedTuple):
    h: torch.Tensor  # (B, H, P, N) recurrent state
    conv: torch.Tensor  # (B, W-1, conv_dim) conv tail


def _dims(cfg: ArchConfig):
    sc = cfg.ssm
    d_inner = sc.expand * cfg.d_model
    n_heads = d_inner // sc.head_dim
    conv_dim = d_inner + 2 * sc.d_state
    return d_inner, n_heads, conv_dim


def init_ssd_params(gen: torch.Generator, cfg: ArchConfig) -> Params:
    sc = cfg.ssm
    d = cfg.d_model
    d_inner, H, conv_dim = _dims(cfg)
    dt_p = cfg.param_dtype
    proj_out = 2 * d_inner + 2 * sc.d_state + H  # z, x, B, C, dt
    return {
        "in_proj": cm.dense_init(gen, d, proj_out, dt_p),
        "conv_w": cm.normal(gen, (sc.conv_width, conv_dim), 0.1, dt_p),
        "conv_b": cm.zeros(gen, (conv_dim,), dt_p),
        "A_log": torch.log(cm.uniform(gen, (H,), 1.0, 16.0)),
        "D": cm.ones(gen, (H,), torch.float32),
        "dt_bias": cm.zeros(gen, (H,), torch.float32),
        "norm_scale": cm.zeros(gen, (d_inner,), dt_p),
        "out_proj": cm.dense_init(gen, d_inner, d, dt_p),
    }


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a: (..., L) -> (..., L, L) lower-triangular pairwise cumulative sums:
    out[l, s] = sum_{s < j <= l} a[j], -inf above the diagonal."""
    L = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=a.device))
    return torch.where(mask, diff, -torch.inf)


def ssd_chunked(
    x: torch.Tensor,  # (B, S, H, P) inputs (already dt-scaled)
    a: torch.Tensor,  # (B, S, H)    log decay per step (A * dt, <= 0)
    Bm: torch.Tensor,  # (B, S, N)
    Cm: torch.Tensor,  # (B, S, N)
    h0: Optional[torch.Tensor],  # (B, H, P, N) carried state
    chunk: int,
    C32: Optional[torch.Tensor] = None,  # Cm before its rounding to x's dtype
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B,S,H,P), h_last (B,H,P,N)). The inter-chunk einsum
    reads ``C32`` where given and S needs no padding, as the reference's XLA
    program reads the unrounded values there (a padded copy is rounded)."""
    f32 = torch.float32
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    L = min(chunk, S)
    pad = (-S) % L
    if pad:
        C32 = None
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        a = F.pad(a, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    nc = (S + pad) // L
    xc = x.reshape(Bsz, nc, L, H, P)
    ac = a.reshape(Bsz, nc, L, H).to(f32)
    Bc = Bm.reshape(Bsz, nc, L, N)
    Cc = Cm.reshape(Bsz, nc, L, N)
    Cc32 = Cc.to(f32) if C32 is None else C32.reshape(Bsz, nc, L, N)

    a_cum = torch.cumsum(ac, dim=2)  # (B, nc, L, H)
    a_tot = a_cum[:, :, -1, :]  # (B, nc, H)

    # --- intra-chunk (quadratic dual form) --------------------------------
    Lmat = torch.exp(_segsum(ac.permute(0, 1, 3, 2)))  # (B, nc, H, L, L)
    scores = torch.einsum("bcln,bcsn->bcls", Cc, Bc)  # (B, nc, L, L), in B / C's dtype
    att = scores[:, :, None, :, :] * Lmat  # (B, nc, H, L, L), float32
    y_diag = torch.einsum("bchls,bcshp->bclhp", att.to(x.dtype), xc)

    # --- chunk summaries ----------------------------------------------------
    decay_tail = torch.exp(a_tot[:, :, None, :] - a_cum)  # (B, nc, L, H)
    states = torch.einsum(
        "bclhp,bcln->bchpn", decay_tail[..., None] * xc.to(f32), Bc.to(f32)
    )  # (B, nc, H, P, N)

    # --- inter-chunk recurrence (a loop over the nc chunk states) -----------
    h = h0.to(f32) if h0 is not None else torch.zeros((Bsz, H, P, N), dtype=f32, device=x.device)
    decay = torch.exp(a_tot)
    h_in = []
    for c in range(nc):
        h_in.append(h)  # the state *entering* the chunk
        h = h * decay[:, c, :, None, None] + states[:, c]
    h_in = torch.stack(h_in, dim=1)  # (B, nc, H, P, N)

    # --- inter-chunk contribution -------------------------------------------
    ch = torch.einsum("bchpn,bcln->bclhp", h_in, Cc32)
    y_off = (torch.exp(a_cum)[..., None] * ch).to(x.dtype)

    y = (y_diag + y_off).reshape(Bsz, nc * L, H, P)[:, :S, :, :]
    return y, h


def ssd_block(
    p: Params,
    cfg: ArchConfig,
    xin: torch.Tensor,  # (B, S, d_model)
    state: Optional[SSDState] = None,
) -> Tuple[torch.Tensor, Optional[SSDState]]:
    sc = cfg.ssm
    cd = cfg.compute_dtype
    f32 = torch.float32
    d_inner, H, conv_dim = _dims(cfg)
    Bsz, S, _ = xin.shape

    zxbcdt = xin @ p["in_proj"].to(cd)
    z, xbc, dt = torch.split(zxbcdt, [d_inner, conv_dim, H], dim=-1)

    # depthwise temporal conv over (x, B, C)
    W = p["conv_w"].shape[0]
    if state is not None:
        ext = torch.cat([state.conv.to(cd), xbc], dim=1)
    else:
        ext = F.pad(xbc, (0, 0, W - 1, 0))
    conv = ext[:, 0:S, :] * p["conv_w"][0].to(cd)
    for k in range(1, W):
        conv = conv + ext[:, k:k + S, :] * p["conv_w"][k].to(cd)
    conv = conv + p["conv_b"].to(cd)
    act32 = conv.to(f32) * cm.sigmoid(conv).to(f32)  # silu, its last step unrounded
    new_tail = ext[:, ext.shape[1] - (W - 1):, :]

    xs, Bm, Cm = torch.split(act32.to(cd), [d_inner, sc.d_state, sc.d_state], dim=-1)
    C32 = act32[..., d_inner + sc.d_state:]
    xs = xs.reshape(Bsz, S, H, sc.head_dim)

    dt_f = cm.softplus(dt.to(f32) + p["dt_bias"])  # (B, S, H)
    A = -torch.exp(p["A_log"])  # (H,) negative
    a = A[None, None, :] * dt_f  # log decay per step
    x_dt = xs * dt_f[..., None].to(cd)

    h0 = state.h if state is not None else None
    y, h_last = ssd_chunked(x_dt, a, Bm, Cm, h0, sc.chunk, C32)
    y = y + xs * p["D"].to(cd)[None, None, :, None]
    y = y.reshape(Bsz, S, d_inner)

    # the gated product is read only by the norm's float32 cast: unrounded
    y = cm.rms_norm(p["norm_scale"], y.to(f32) * cm.silu(z).to(f32), dtype=cd)
    out = y @ p["out_proj"].to(cd)
    new_state = (
        SSDState(h=h_last.to(f32), conv=new_tail.to(cd)) if state is not None else None
    )
    return out, new_state


def init_ssd_state(cfg: ArchConfig, batch: int, device) -> SSDState:
    sc = cfg.ssm
    d_inner, H, conv_dim = _dims(cfg)
    return SSDState(
        h=torch.zeros((batch, H, sc.head_dim, sc.d_state), dtype=torch.float32, device=device),
        conv=torch.zeros((batch, sc.conv_width - 1, conv_dim), dtype=cfg.compute_dtype,
                         device=device),
    )
