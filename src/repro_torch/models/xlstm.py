"""xLSTM blocks, the ssm family's (xlstm-1.3b) layers: the mLSTM (a
per-head matrix memory, chunkwise parallel) and the sLSTM (a scalar
memory with recurrent mixing, strictly sequential), after
arXiv:2405.04517.

The mLSTM runs in its stabilised chunkwise form for training and
prefill (quadratic gating matrices within a chunk, the (dk, dk) matrix
state carried across chunks) and as the exact one-token recurrence for
decode. The sLSTM is a recurrence over the tokens with block-diagonal
per-head recurrent matrices. All of it is plain tensor code, as the
reference computes it outside any Pallas kernel; the blocks' norms
(``ln`` over d_model, the mLSTM's ``out_norm`` over d_in, the sLSTM's
``out_norm`` over d_model) go through ``ops.rmsnorm``.

Port of src/repro/models/xlstm.py. Differences of structure, none of
value beyond summation order:
- a Python loop over the chunks and over the tokens takes the place of
  the reference's ``lax.scan``s;
- the states are dicts (mLSTM ``C``, ``n``, ``m``; sLSTM ``h``, ``c``,
  ``n``, ``m``), and a decode writes the new state into the tensors it
  was given (in place, as ``models/ssm.py`` writes the Mamba2 states):
  the mLSTM's ``C`` is (B, H, dk, dk) f32, 134 MB a layer at batch 8 on
  xlstm-1.3b, and an out-of-place update would move it several times;
- the sLSTM's four recurrent products of a token (``r_z``, ``r_i``,
  ``r_f``, ``r_o``) are one batched product over the four matrices
  stacked once per call: each output element is the same dot product
  over dh.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import params as P

_GATES = ("z", "i", "f", "o")


def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """log sigmoid(x) = min(x, 0) - log1p(exp(-|x|)), the reference's
    stabilised form (``clamp`` passes the whole gradient at x = 0, as
    ``jnp.minimum`` against a literal does)."""
    return x.clamp(max=0.0) - torch.log1p(torch.exp(-torch.abs(x)))


# ======================================================================
# mLSTM
# ======================================================================
def _mlstm_dims(cfg: ModelConfig):
    H = cfg.num_heads
    d_in = int(cfg.d_model * cfg.xlstm.proj_factor_mlstm)
    dk = d_in // H
    return H, d_in, dk


def decl_mlstm(cfg: ModelConfig) -> Dict[str, Any]:
    d = cfg.d_model
    H, d_in, dk = _mlstm_dims(cfg)
    return {
        "ln": P.norm(d),
        "up_proj": P.linear(d, 2 * d_in, "embed", "ffn"),   # [x_in, z_gate]
        # block-diagonal per-head projections: (H, dk, dk)
        "wq": P.ParamDecl((H, dk, dk), (None, None, None), "normal",
                          1.0 / math.sqrt(dk)),
        "wk": P.ParamDecl((H, dk, dk), (None, None, None), "normal",
                          1.0 / math.sqrt(dk)),
        "wv": P.ParamDecl((H, dk, dk), (None, None, None), "normal",
                          1.0 / math.sqrt(dk)),
        "w_i": P.ParamDecl((d_in, H), ("ffn", None), "normal", 0.02),
        "w_f": P.ParamDecl((d_in, H), ("ffn", None), "normal", 0.02),
        "b_i": P.ParamDecl((H,), (None,), "zeros"),
        "b_f": P.ParamDecl((H,), (None,), "ones"),
        "out_norm": P.norm(d_in, "ffn"),
        "down_proj": P.linear(d_in, d, "ffn", "embed"),
    }


def _mlstm_chunked(q, k, v, logf, logi, chunk: int):
    """Stabilised chunkwise mLSTM from the zero state.

    q/k/v: (B,S,H,D) f32; logf/logi: (B,S,H) log forget/input gates; S a
    multiple of ``chunk``. Returns h (B,S,H,D) and the final state
    {"C": (B,H,D,D), "n": (B,H,D), "m": (B,H)}."""
    B, S, H, D = q.shape
    nc = S // chunk
    qc = q.reshape(B, nc, chunk, H, D)
    kc = k.reshape(B, nc, chunk, H, D) / math.sqrt(D)
    vc = v.reshape(B, nc, chunk, H, D)
    lf = logf.reshape(B, nc, chunk, H)
    li = logi.reshape(B, nc, chunk, H)

    Fc = torch.cumsum(lf, dim=2)                              # (B,nc,Q,H)
    Fend = Fc[:, :, -1]                                       # (B,nc,H)
    # intra-chunk log weights W[z,l] = F_z - F_l + i_l (z >= l), masked by
    # an iota comparison as the reference builds it
    Wlog = Fc[:, :, :, None] - Fc[:, :, None, :] + li[:, :, None, :]
    ar = torch.arange(chunk, device=q.device)
    tri = ar[:, None] >= ar[None, :]
    Wlog = torch.where(tri[None, None, :, :, None], Wlog, -torch.inf)

    C = q.new_zeros((B, H, D, D))
    n = q.new_zeros((B, H, D))
    m = q.new_full((B, H), -1e30)
    hs = []
    # each input taken apart once: autograd then stacks one gradient per
    # input instead of filling a zero tensor per chunk
    chunks = zip(*(t.unbind(1) for t in (qc, kc, vc, Wlog, Fc, li, Fend)))
    for qi, ki, vi, Wl, F_c, li_c, Fe in chunks:
        m_local = Wl.amax(dim=2)                              # (B,Q,H)
        m_new = torch.maximum(m_local, F_c + m[:, None, :])
        Dmat = torch.exp(Wl - m_new[:, :, None, :])
        s_intra = torch.einsum("bzhd,blhd->bzlh", qi, ki)
        h_intra = torch.einsum("bzlh,bzlh,blhd->bzhd", s_intra, Dmat, vi)
        n_intra = torch.einsum("bzlh,bzlh->bzh", s_intra, Dmat)
        inter_w = torch.exp(F_c + m[:, None, :] - m_new)
        h_inter = torch.einsum("bzhd,bhde->bzhe", qi, C) * inter_w[..., None]
        n_inter = torch.einsum("bzhd,bhd->bzh", qi, n) * inter_w
        n_tot = torch.maximum(torch.abs(n_intra + n_inter),
                              torch.exp(-m_new))
        hs.append((h_intra + h_inter) / n_tot[..., None])

        # state update: key l weighs exp(Fe - F_l + i_l), stabilised
        kw_log = Fe[:, None, :] - F_c + li_c                  # (B,Q,H)
        m_kw = kw_log.amax(dim=1)                             # (B,H)
        m_state = torch.maximum(Fe + m, m_kw)
        decay = torch.exp(Fe + m - m_state)                   # (B,H)
        kw = torch.exp(kw_log - m_state[:, None, :])          # (B,Q,H)
        C = (C * decay[..., None, None]
             + torch.einsum("blh,blhd,blhe->bhde", kw, ki, vi))
        n = n * decay[..., None] + torch.einsum("blh,blhd->bhd", kw, ki)
        m = m_state
    h = torch.stack(hs, dim=1).reshape(B, S, H, D)
    return h, {"C": C, "n": n, "m": m}


def _mlstm_recurrent_step(q, k, v, logf, logi, state):
    """One-token exact recurrence. q/k/v: (B,H,D); logf/logi: (B,H).
    Writes the new state into ``state``'s tensors (in place: C by one
    scaling pass and one rank-1 update) and returns h (B,H,D)."""
    C, n, m = state["C"], state["n"], state["m"]
    m_new = torch.maximum(logf + m, logi)
    fg = torch.exp(logf + m - m_new)
    ig = torch.exp(logi - m_new)
    C.mul_(fg[..., None, None]).addcmul_((ig[..., None] * k)[..., :, None],
                                         v[..., None, :])
    n.mul_(fg[..., None]).add_(ig[..., None] * k)
    m.copy_(m_new)
    num = torch.matmul(q[..., None, :], C)[..., 0, :]
    den = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", q, n)),
                        torch.exp(-m_new))
    return num / den[..., None]


def apply_mlstm(p, cfg: ModelConfig, x: torch.Tensor, *,
                state: Optional[Dict[str, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """mLSTM block. x: (B,S,d) -> (x + block(x), state).

    state None: the chunked path (training, prefill) from the zero
    state; the final state comes back. state {"C","n","m"}: the exact
    recurrence over the S tokens, written into ``state`` in place."""
    H, d_in, dk = _mlstm_dims(cfg)
    B, S, _ = x.shape
    dt = x.dtype
    f32 = torch.float32
    h = L.apply_rmsnorm(p["ln"], x, cfg.norm_eps)
    up = h @ p["up_proj"]["w"].to(dt)
    xi, z = up.chunk(2, dim=-1)

    xh = xi.reshape(B, S, H, dk)
    q = torch.einsum("bshd,hde->bshe", xh, p["wq"].to(dt)).to(f32)
    k = torch.einsum("bshd,hde->bshe", xh, p["wk"].to(dt)).to(f32)
    v = torch.einsum("bshd,hde->bshe", xh, p["wv"].to(dt)).to(f32)
    xf = xi.to(f32)
    logi = xf @ p["w_i"].to(f32) + p["b_i"].to(f32)
    logf = _log_sigmoid(xf @ p["w_f"].to(f32) + p["b_f"].to(f32))

    if state is None:
        Q = min(cfg.xlstm.chunk_size, S)
        pad = -(-S // Q) * Q - S
        if pad:
            q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
            logf = F.pad(logf, (0, 0, 0, pad))
            logi = F.pad(logi, (0, 0, 0, pad), value=-1e30)
        hseq, new_state = _mlstm_chunked(q, k, v, logf, logi, Q)
        hseq = hseq[:, :S]
    else:
        # the chunked path scales k by 1/sqrt(dk); mirrored here
        hseq = torch.stack([
            _mlstm_recurrent_step(q[:, t], k[:, t] / math.sqrt(dk), v[:, t],
                                  logf[:, t], logi[:, t], state)
            for t in range(S)], dim=1)
        new_state = state

    hseq = hseq.reshape(B, S, d_in).to(dt)
    hseq = L.apply_rmsnorm(p["out_norm"], hseq, cfg.norm_eps)
    hseq = hseq * F.silu(z)
    return x + hseq @ p["down_proj"]["w"].to(dt), new_state


def init_mlstm_state(cfg: ModelConfig, batch: int, *,
                     device) -> Dict[str, torch.Tensor]:
    H, d_in, dk = _mlstm_dims(cfg)
    return {"C": torch.zeros((batch, H, dk, dk), device=device),
            "n": torch.zeros((batch, H, dk), device=device),
            "m": torch.full((batch, H), -1e30, device=device)}


# ======================================================================
# sLSTM
# ======================================================================
def _slstm_dims(cfg: ModelConfig):
    H = cfg.num_heads
    dh = cfg.d_model // H
    return H, dh


def decl_slstm(cfg: ModelConfig) -> Dict[str, Any]:
    d = cfg.d_model
    H, dh = _slstm_dims(cfg)
    d_up = int(cfg.d_model * cfg.xlstm.proj_factor_slstm)
    gates = {}
    for g in _GATES:
        gates[f"w_{g}"] = P.linear(d, d, "embed", "q_feat")
        # block-diagonal recurrent mixing: per-head (dh, dh)
        gates[f"r_{g}"] = P.ParamDecl((H, dh, dh), (None, None, None),
                                      "normal", 1.0 / math.sqrt(dh))
        gates[f"b_{g}"] = P.ParamDecl((d,), ("embed",),
                                      "ones" if g == "f" else "zeros")
    return {
        "ln": P.norm(d),
        **gates,
        "out_norm": P.norm(d),
        "up": P.linear(d, d_up, "embed", "ffn"),
        "gate": P.linear(d, d_up, "embed", "ffn"),
        "down": P.linear(d_up, d, "ffn", "embed"),
    }


def _slstm_cell(g, carry):
    """One token of the sLSTM cell in the head-major layout: g (H,B,4,dh)
    the gate pre-activations z, i, f, o with the recurrent mixing added;
    carry (h, c, n, m), each (H,B,dh). Returns the new carry."""
    _, c_prev, n_prev, m_prev = carry
    gz, logi, gf, go = g.unbind(2)
    z = torch.tanh(gz)
    o = torch.sigmoid(go)
    # logf + m_prev, computed once for both of its uses
    lfm = _log_sigmoid(gf) + m_prev
    m_new = torch.maximum(lfm, logi)
    ig = torch.exp(logi - m_new)
    fg = torch.exp(lfm - m_new)
    c_new = fg * c_prev + ig * z
    n_new = torch.maximum(fg * n_prev + ig, torch.exp(-m_new))
    return o * c_new / n_new, c_new, n_new, m_new


def apply_slstm(p, cfg: ModelConfig, x: torch.Tensor, *,
                state: Optional[Dict[str, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """sLSTM block. x: (B,S,d) -> (x + block(x), state): the recurrence
    over the S tokens from the initial state (state None) or from
    ``state`` {"h","c","n","m"} (each (B,d) f32), which is then written
    in place."""
    H, dh = _slstm_dims(cfg)
    B, S, d = x.shape
    dt = x.dtype
    f32 = torch.float32
    h = L.apply_rmsnorm(p["ln"], x, cfg.norm_eps)
    pre = [(h @ p[f"w_{g}"]["w"].to(dt)).to(f32) + p[f"b_{g}"].to(f32)
           for g in _GATES]
    # (S, H, B, 4*dh): a token's four gates, head-major, contiguous
    xs = torch.stack(pre, dim=2).reshape(B, S, 4, H, dh) \
        .permute(1, 3, 0, 2, 4).reshape(S, H, B, 4 * dh)
    # the four recurrent matrices side by side: (H, dh, 4*dh)
    R = torch.stack([p[f"r_{g}"].to(f32) for g in _GATES], dim=2) \
        .reshape(H, dh, 4 * dh)

    def head_major(t):                            # (B,d) -> (H,B,dh)
        return t.reshape(B, H, dh).transpose(0, 1)
    if state is None:
        zero = x.new_zeros((H, B, dh), dtype=f32)
        carry = (zero, zero, torch.ones_like(zero), zero)
    else:
        carry = tuple(head_major(state[key]) for key in ("h", "c", "n", "m"))
    hs = []
    for xt in xs.unbind(0):
        g = torch.baddbmm(xt, carry[0], R).view(H, B, 4, dh)
        carry = _slstm_cell(g, carry)
        hs.append(carry[0])
    hseq = torch.stack(hs).permute(2, 0, 1, 3).reshape(B, S, d).to(dt)
    final = [t.transpose(0, 1).reshape(B, d) for t in carry]
    if state is None:
        new_state = dict(zip(("h", "c", "n", "m"), final))
    else:
        for key, t in zip(("h", "c", "n", "m"), final):
            state[key].copy_(t)
        new_state = state

    hseq = L.apply_rmsnorm(p["out_norm"], hseq, cfg.norm_eps)
    # post-cell gated up/down projection (the xLSTM block structure)
    u = F.gelu(hseq @ p["up"]["w"].to(dt), approximate="tanh")
    gate = hseq @ p["gate"]["w"].to(dt)
    out = (u * torch.sigmoid(gate)) @ p["down"]["w"].to(dt)
    return x + out, new_state


def init_slstm_state(cfg: ModelConfig, batch: int, *,
                     device) -> Dict[str, torch.Tensor]:
    d = cfg.d_model
    return {"h": torch.zeros((batch, d), device=device),
            "c": torch.zeros((batch, d), device=device),
            "n": torch.ones((batch, d), device=device),
            "m": torch.zeros((batch, d), device=device)}
