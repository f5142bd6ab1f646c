"""RWKV-6 "Finch" block (arXiv:2404.05892): attention-free time mixing with
a data-dependent decay, and squared-relu channel mixing.  Port of
``repro.models.rwkv6``.

Per head (head_dim Dh): a state S ∈ R^{Dh×Dh},
    S_t = diag(w_t)·S_{t−1} + k_tᵀ v_t
    y_t = r_t·(S_{t−1} + diag(u)·k_tᵀ v_t)
with w_t = exp(−exp(decay_t)) per channel, in float32, and the 5-way
data-dependent token shift (ddlerp) producing the r/k/v/w/g streams
through a small LoRA.

``rwkv_time_scan`` (prefill, forward) is a Python loop over time with the
float32 state, updated in place for inference and, when a backward pass
will follow, in the reference's checkpointed chunks with out-of-place
updates (``mamba.chunked_recurrence``); either way it computes
r_t·(S + diag(u)·kᵀv) as r_t·S + (Σ_k r_t u k_t)·v_t, the same sum
without the (B, H, Dh, Dh) temporary.  ``rwkv_time_step`` is the O(1)
decode update.  Nothing in either reads a tensor on the host, so neither
syncs.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import ModelConfig, dense_init
from repro_torch.models.mamba import (check_time_chunk, chunked_recurrence,
                                     needs_grad)

TM_RANK = 32  # token-shift LoRA rank (RWKV6 TIME_MIX_EXTRA_DIM)
GROUP_NORM_EPS = 64e-5   # the per-head group norm's eps (not cfg.norm_eps)


class RwkvState(NamedTuple):
    x_prev_att: torch.Tensor   # (B, D) last token fed to time mixing
    x_prev_ffn: torch.Tensor   # (B, D) last token fed to channel mixing
    wkv: torch.Tensor          # (B, H, Dh, Dh) per-head state, float32


def _dims(cfg: ModelConfig):
    Dh = cfg.rwkv_head_dim
    return cfg.d_model // Dh, Dh


def init_rwkv_time(cfg: ModelConfig, generator, device) -> dict:
    """The reference's time-mix leaves: the token-shift mixes at 0.5, the
    decay base and the group norm's bias zeros, its scale ones, and ``wo``
    zeros (the official RWKV init: the residual branch is silent at init);
    the rest ``dense_init``, fan-in the first axis (``tm_w2`` (5, 32, D)
    std 1/√5, ``bonus_u`` (H, Dh) 1/√H, ROADMAP.md queue 3 item 10)."""
    D = cfg.d_model
    H, Dh = _dims(cfg)
    R = cfg.rwkv_decay_lora_rank
    pd = cfg.pdtype

    def w(shape):
        return dense_init(shape, pd, generator, device)

    def full(shape, value):
        return torch.full(shape, value, dtype=pd, device=device)

    return {
        "mu_x": full((D,), 0.5),
        "mu_rkvwg": full((5, D), 0.5),
        "tm_w1": w((D, 5 * TM_RANK)),
        "tm_w2": w((5, TM_RANK, D)),
        "decay_base": full((D,), 0.0),
        "dd_w1": w((D, R)),
        "dd_w2": w((R, D)),
        "bonus_u": w((H, Dh)),
        "wr": w((D, D)),
        "wk": w((D, D)),
        "wv": w((D, D)),
        "wg": w((D, D)),
        "wo": full((D, D), 0.0),
        "ln_scale": full((D,), 1.0),
        "ln_bias": full((D,), 0.0),
    }


def init_rwkv_channel(cfg: ModelConfig, generator, device) -> dict:
    """The channel mix: mixes at 0.5, ``wv`` zeros (official RWKV)."""
    D, Fd = cfg.d_model, cfg.d_ff
    pd = cfg.pdtype
    return {
        "mu_k": torch.full((D,), 0.5, dtype=pd, device=device),
        "mu_r": torch.full((D,), 0.5, dtype=pd, device=device),
        "wk": dense_init((D, Fd), pd, generator, device),
        "wv": torch.zeros((Fd, D), dtype=pd, device=device),
        "wr": dense_init((D, D), pd, generator, device),
    }


def _shifted(x: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
    """The token shift's difference: (x_prev, x_0 … x_{S−2}) − x."""
    xp = torch.cat([x_prev[:, None, :].to(x.dtype), x[:, :-1, :]], dim=1)
    return xp - x


def _ddlerp(p: dict, x: torch.Tensor, sx: torch.Tensor):
    """Data-dependent 5-way token shift.  x, sx (B, S, D) -> (xr, xk, xv,
    xw, xg), each (B, S, D)."""
    xxx = x + sx * p["mu_x"].to(x.dtype)
    lora = torch.tanh(xxx @ p["tm_w1"].to(x.dtype))
    B, S, _ = lora.shape
    lora = lora.reshape(B, S, 5, TM_RANK)
    mix = torch.einsum("bsfr,frd->fbsd", lora, p["tm_w2"].to(x.dtype))
    mu = p["mu_rkvwg"].to(x.dtype)                           # (5, D)
    outs = x[None] + sx[None] * (mu[:, None, None, :] + mix)  # (5, B, S, D)
    return tuple(outs)


def _streams(p: dict, x: torch.Tensor, x_prev: torch.Tensor,
             cfg: ModelConfig):
    """r, k, v (B, S, H, Dh), the gate g (B, S, D) and the decay w
    (B, S, H, Dh) float32 in (0, 1), from x (B, S, D) and the token before
    it, x_prev (B, D)."""
    H, Dh = _dims(cfg)
    B, S, _ = x.shape
    xr, xk, xv, xw, xg = _ddlerp(p, x, _shifted(x, x_prev))
    r = xr @ p["wr"].to(x.dtype)
    k = xk @ p["wk"].to(x.dtype)
    v = xv @ p["wv"].to(x.dtype)
    g = F.silu(xg @ p["wg"].to(x.dtype))
    dd = torch.tanh(xw) @ p["dd_w1"].to(x.dtype)
    decay = p["decay_base"].to(x.dtype) + dd @ p["dd_w2"].to(x.dtype)
    w = torch.exp(-torch.exp(decay.to(torch.float32)))
    hd = (B, S, H, Dh)
    return r.reshape(hd), k.reshape(hd), v.reshape(hd), g, w.reshape(hd)


def _out_norm(p: dict, y: torch.Tensor, g: torch.Tensor, x_dtype,
              cfg: ModelConfig) -> torch.Tensor:
    """Per-head group norm (population variance, eps 64e-5), the gate, the
    out projection.  y (B, S, H, Dh)."""
    y32 = y.to(torch.float32)
    mu = torch.mean(y32, -1, keepdim=True)
    var = torch.var(y32, -1, keepdim=True, correction=0)
    yn = (y32 - mu) * torch.rsqrt(var + GROUP_NORM_EPS)
    B, S, H, Dh = y.shape
    yn = yn.reshape(B, S, H * Dh) * p["ln_scale"].to(torch.float32) \
        + p["ln_bias"].to(torch.float32)
    out = yn.to(x_dtype) * g
    return out @ p["wo"].to(x_dtype)


def rwkv_time_scan(p: dict, x: torch.Tensor, x_prev: torch.Tensor,
                   wkv0: torch.Tensor, cfg: ModelConfig,
                   time_chunk: int | None = None):
    """Time mixing over a full sequence.  x (B, S, D); x_prev (B, D); wkv0
    (B, H, Dh, Dh) float32 (not changed).  Returns (out (B, S, D), the new
    x_prev, the new wkv state)."""
    B, S, _ = x.shape
    r, k, v, g, w = _streams(p, x, x_prev, cfg)
    check_time_chunk(S, cfg, time_chunk)
    H, Dh = r.shape[2], r.shape[3]
    u = p["bonus_u"].to(torch.float32)                       # (H, Dh)
    # (S, B·H, ·) float32, time-major
    r32, k32, v32, w32 = (t.to(torch.float32).permute(1, 0, 2, 3)
                          .reshape(S, B * H, Dh) for t in (r, k, v, w))
    ruk = torch.sum(r32 * (u.repeat(B, 1) * k32), -1, keepdim=True)
    if needs_grad(x, p):
        def step(st, r_t, k_t, v_t, w_t, ruk_t):
            y = torch.addcmul(torch.bmm(r_t[:, None, :], st),
                              ruk_t[:, None, :], v_t[:, None, :])
            st = torch.baddbmm(st * w_t[:, :, None], k_t[:, :, None],
                               v_t[:, None, :])
            return st, y

        state, ys = chunked_recurrence(
            step, wkv0.reshape(B * H, Dh, Dh), (r32, k32, v32, w32, ruk),
            min(time_chunk or cfg.time_chunk, S))
    else:
        state = wkv0.reshape(B * H, Dh, Dh).clone()
        ys = torch.empty((S, B * H, 1, Dh), dtype=torch.float32,
                         device=x.device)
        for t in range(S):
            torch.bmm(r32[t, :, None, :], state, out=ys[t])  # r·S_{t−1}
            ys[t].addcmul_(ruk[t, :, None, :], v32[t, :, None, :])
            state.mul_(w32[t, :, :, None])
            state.baddbmm_(k32[t, :, :, None], v32[t, :, None, :])
    y = ys.reshape(S, B, H, Dh).transpose(0, 1)
    out = _out_norm(p, y, g, x.dtype, cfg)
    return out, x[:, -1, :], state.reshape(B, H, Dh, Dh)


def rwkv_channel(p: dict, x: torch.Tensor, x_prev: torch.Tensor,
                 cfg: ModelConfig):
    """Channel mixing (squared-relu FFN with a token shift).  Returns
    (out, the new x_prev)."""
    sx = _shifted(x, x_prev)
    xk = x + sx * p["mu_k"].to(x.dtype)
    xr = x + sx * p["mu_r"].to(x.dtype)
    kk = torch.square(torch.relu(xk @ p["wk"].to(x.dtype)))
    vv = kk @ p["wv"].to(x.dtype)
    rr = torch.sigmoid(xr @ p["wr"].to(x.dtype))
    return rr * vv, x[:, -1, :]


def rwkv_time_step(p: dict, x: torch.Tensor, state: RwkvState,
                   cfg: ModelConfig):
    """Decode: x (B, 1, D) -> (out (B, 1, D), the new x_prev, the new wkv
    state), one step of ``rwkv_time_scan``'s recurrence."""
    r, k, v, g, w = _streams(p, x, state.x_prev_att, cfg)
    B, _, H, Dh = r.shape
    u = p["bonus_u"].to(torch.float32)
    r32, k32, v32, w32 = (t.to(torch.float32).reshape(B * H, Dh)
                          for t in (r, k, v, w))
    ruk = torch.sum(r32 * (u.repeat(B, 1) * k32), -1, keepdim=True)
    wkv = state.wkv.reshape(B * H, Dh, Dh)
    y = torch.bmm(r32[:, None, :], wkv).addcmul_(ruk[:, None, :],
                                                 v32[:, None, :])
    new_wkv = torch.baddbmm(wkv * w32[:, :, None], k32[:, :, None],
                            v32[:, None, :])
    out = _out_norm(p, y.reshape(B, 1, H, Dh), g, x.dtype, cfg)
    return out, x[:, 0, :], new_wkv.reshape(B, H, Dh, Dh)


def init_rwkv_state(cfg: ModelConfig, batch: int, dtype,
                    device) -> RwkvState:
    H, Dh = _dims(cfg)
    return RwkvState(
        x_prev_att=torch.zeros((batch, cfg.d_model), dtype=dtype,
                               device=device),
        x_prev_ffn=torch.zeros((batch, cfg.d_model), dtype=dtype,
                               device=device),
        wkv=torch.zeros((batch, H, Dh, Dh), dtype=torch.float32,
                        device=device))
