"""Mamba2 block (State Space Duality form), the hybrid family's (zamba2)
state-space layer.

Training and prefill use the chunked SSD algorithm: quadratic
attention-like products within chunks and a small recurrence across
chunks; decode is the exact O(1) recurrence. The SSD products are plain
einsums, as the reference computes them outside any Pallas kernel; the
block's two norms (``ln`` over d_model, the gated ``gate_norm`` over
d_inner) go through ``ops.rmsnorm``.

Port of src/repro/models/ssm.py. The one difference of structure: the
decode path writes the new conv and SSM state into the cache views it
was given (in place, as the port's dense K/V cache does) and returns
them; the reference returns fresh arrays.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import params as P


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    nheads = d_inner // s.head_dim
    return d_inner, nheads, s.state_dim, s.head_dim, s.conv_width


def decl_mamba(cfg: ModelConfig) -> Dict[str, Any]:
    d = cfg.d_model
    d_inner, H, N, Pd, W = _dims(cfg)
    conv_ch = d_inner + 2 * N
    return {
        "ln": P.norm(d),
        # in_proj -> [z(d_inner), x(d_inner), B(N), C(N), dt(H)]
        "in_proj": P.linear(d, 2 * d_inner + 2 * N + H, "embed", "ssm_inner"),
        "conv_w": P.ParamDecl((W, conv_ch), (None, "ssm_inner"), "normal",
                              1.0 / math.sqrt(W)),
        "conv_b": P.ParamDecl((conv_ch,), ("ssm_inner",), "zeros"),
        "A_log": P.ParamDecl((H,), (None,), "zeros"),
        "D": P.ParamDecl((H,), (None,), "ones"),
        "dt_bias": P.ParamDecl((H,), (None,), "zeros"),
        "gate_norm": P.norm(d_inner, "ssm_inner"),
        "out_proj": P.linear(d_inner, d, "ssm_inner", "embed"),
    }


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x: (..., T) log-decays -> (..., T, T) lower-tri cumulative sums,
    -inf above the diagonal."""
    T = x.shape[-1]
    c = torch.cumsum(x, dim=-1)
    seg = c[..., :, None] - c[..., None, :]
    # an iota comparison, as the reference builds its mask
    ar = torch.arange(T, device=x.device)
    mask = ar[:, None] >= ar[None, :]
    return torch.where(mask, seg, -torch.inf)


def _ssd_chunked(xh, dt, A, Bm, Cm, chunk: int):
    """Chunked SSD scan.

    xh: (B,S,H,P) value heads; dt: (B,S,H) softplus'd step; A: (H,) < 0;
    Bm/Cm: (B,S,N) input/output mats (single group); S a multiple of
    ``chunk``. Returns y (B,S,H,P) f32 and the final state (B,H,N,P)."""
    Bsz, S, H, Pd = xh.shape
    N = Bm.shape[-1]
    nc = S // chunk
    f32 = torch.float32

    xc = xh.reshape(Bsz, nc, chunk, H, Pd).to(f32)
    dtc = dt.reshape(Bsz, nc, chunk, H).to(f32)
    Bc = Bm.reshape(Bsz, nc, chunk, N).to(f32)
    Cc = Cm.reshape(Bsz, nc, chunk, N).to(f32)

    dA = dtc * A.to(f32)                                      # (B,nc,Q,H)
    dAc = torch.cumsum(dA, dim=2)                             # within-chunk
    dAend = dAc[:, :, -1:]                                    # (B,nc,1,H)

    # 1) intra-chunk (quadratic within chunk): L = exp(segsum(dA))
    L = torch.exp(_segsum(dA.permute(0, 1, 3, 2)))            # (B,nc,H,Q,Q)
    scores = torch.einsum("bczn,bcln->bczl", Cc, Bc)          # (B,nc,Q,Q)
    M = scores[:, :, None] * L                                # (B,nc,H,Q,Q)
    xdt = xc * dtc[..., None]                                 # dt-weighted
    y_diag = torch.einsum("bchzl,bclhp->bczhp", M, xdt)

    # 2) chunk states: decay-to-end weighted outer products B (x dt)
    decay_states = torch.exp(dAend - dAc)                     # (B,nc,Q,H)
    states = torch.einsum("bcln,bclh,bclhp->bchnp",
                          Bc, decay_states * dtc, xc)         # (B,nc,H,N,P)

    # 3) inter-chunk recurrence over the nc chunks, emitting the state
    # before each chunk (the reference's lax.scan)
    chunk_decay = torch.exp(dAend[:, :, 0])                   # (B,nc,H)
    h = torch.zeros((Bsz, H, N, Pd), dtype=f32, device=xh.device)
    prevs = []
    for c in range(nc):
        prevs.append(h)
        h = h * chunk_decay[:, c][..., None, None] + states[:, c]
    h_prevs = torch.stack(prevs, dim=1)                       # (B,nc,H,N,P)

    # 4) inter-chunk output: C_t decayed against previous chunk state
    out_decay = torch.exp(dAc)                                # (B,nc,Q,H)
    y_off = torch.einsum("bczn,bczh,bchnp->bczhp", Cc, out_decay, h_prevs)

    y = (y_diag + y_off).reshape(Bsz, S, H, Pd)
    return y, h


def _causal_conv(x, w, b, state: Optional[torch.Tensor] = None):
    """Depthwise causal conv. x: (B,S,ch), w: (W,ch), state: (B,W-1,ch)
    (the last W-1 inputs). Returns (out (B,S,ch), new state)."""
    W = w.shape[0]
    S = x.shape[1]
    if state is None:
        pad = torch.zeros((x.shape[0], W - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                           # (B, S+W-1, ch)
    # the taps summed by a reduce, as the reference sums them
    taps = [xp[:, i:i + S] * w[i] for i in range(W)]
    out = functools.reduce(torch.add, taps) + b
    return out, xp[:, S:]


def apply_mamba(p, cfg: ModelConfig, x: torch.Tensor, *,
                state: Optional[Dict[str, torch.Tensor]] = None,
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mamba2 block. x: (B,S,d) -> (x + block(x), state).

    state None: the chunked path (training, prefill); the returned state
    is the final SSM state and conv window. state {'ssm': (B,H,N,P) f32,
    'conv': (B,W-1,ch)}: the exact recurrence over the S tokens; the new
    state is written into ``state``'s tensors in place and returned."""
    d_inner, H, N, Pd, W = _dims(cfg)
    s = cfg.ssm
    B_, S, _ = x.shape
    dt_model = x.dtype

    h = L.apply_rmsnorm(p["ln"], x, cfg.norm_eps)
    zxbcdt = h @ p["in_proj"]["w"].to(dt_model)
    z, xs, Bm, Cm, dt = torch.split(zxbcdt, [d_inner, d_inner, N, N, H],
                                    dim=-1)

    conv_in = torch.cat([xs, Bm, Cm], dim=-1)
    conv_state = None if state is None else state["conv"]
    conv_out, new_conv = _causal_conv(conv_in, p["conv_w"].to(dt_model),
                                      p["conv_b"].to(dt_model), conv_state)
    conv_out = F.silu(conv_out)
    xs, Bm, Cm = torch.split(conv_out, [d_inner, N, N], dim=-1)

    # softplus as max(x,0)+log1p(exp(-|x|)), the reference's stabilised
    # form (F.softplus gives other low bits)
    dt = dt.to(torch.float32) + p["dt_bias"].to(torch.float32)
    dt = torch.maximum(dt, dt.new_zeros(())) + torch.log1p(
        torch.exp(-torch.abs(dt)))
    A = -torch.exp(p["A_log"].to(torch.float32))              # (H,) negative
    xh = xs.reshape(B_, S, H, Pd)

    if state is None:
        # pad S to a chunk multiple
        Q = min(s.chunk_size, S)
        pad = -(-S // Q) * Q - S
        if pad:
            xh_p = F.pad(xh, (0, 0, 0, 0, 0, pad))
            dt_p = F.pad(dt, (0, 0, 0, pad))
            Bm_p = F.pad(Bm, (0, 0, 0, pad))
            Cm_p = F.pad(Cm, (0, 0, 0, pad))
        else:
            xh_p, dt_p, Bm_p, Cm_p = xh, dt, Bm, Cm
        y, hT = _ssd_chunked(xh_p, dt_p, A, Bm_p, Cm_p, Q)
        y = y[:, :S]
        out_state = {"ssm": hT, "conv": new_conv}
    else:
        # recurrent decode: h' = exp(dt*A) h + dt * B (outer) x ; y = C . h
        hs = state["ssm"].to(torch.float32)                   # (B,H,N,P)
        ys = []
        for t in range(S):
            dt_t = dt[:, t]
            dA = torch.exp(dt_t * A)                          # (B,H)
            upd = torch.einsum("bn,bh,bhp->bhnp", Bm[:, t].to(torch.float32),
                               dt_t, xh[:, t].to(torch.float32))
            hs = hs * dA[..., None, None] + upd
            ys.append(torch.einsum("bn,bhnp->bhp",
                                   Cm[:, t].to(torch.float32), hs))
        y = torch.stack(ys, dim=1)                            # (B,S,H,P)
        state["ssm"].copy_(hs)
        state["conv"].copy_(new_conv)
        out_state = state

    y = y + p["D"].to(torch.float32)[None, None, :, None] \
        * xh.to(torch.float32)
    y = y.reshape(B_, S, d_inner).to(dt_model)
    # gated RMSNorm (mamba2): norm(y * silu(z))
    y = y * F.silu(z)
    y = L.apply_rmsnorm(p["gate_norm"], y, cfg.norm_eps)
    out = y @ p["out_proj"]["w"].to(dt_model)
    return x + out, out_state


def init_mamba_state(cfg: ModelConfig, batch: int, dtype=torch.float32, *,
                     device) -> Dict[str, torch.Tensor]:
    d_inner, H, N, Pd, W = _dims(cfg)
    return {
        "ssm": torch.zeros((batch, H, N, Pd), dtype=torch.float32,
                           device=device),
        "conv": torch.zeros((batch, W - 1, d_inner + 2 * N), dtype=dtype,
                            device=device),
    }
