"""Mamba (selective SSM) block, Jamba's sequence mixer (arXiv:2403.19887).
Port of ``repro.models.mamba``.

Selective state space: per token, input-dependent (Δ, B, C) select what the
state keeps;  h_t = exp(Δ_t·A)·h_{t-1} + Δ_t·B_t·x_t,  y_t = C_t·h_t + D·x_t.

Two paths sharing parameters:
* ``mamba_scan``: the full sequence (prefill, forward), a Python loop over
  time with the state in float32.  For inference (serving) the state is
  updated in place.  When a backward pass will follow (grad mode on and
  an input or parameter that requires grad) it is the reference's
  chunked form instead: an outer loop over ``S / time_chunk`` chunks,
  each under ``torch.utils.checkpoint`` with out-of-place updates inside,
  so autograd saves only the chunk-boundary states (the reference notes
  ~2 GB for one 4k-token Jamba layer without it).  Both give the same
  values;
* ``mamba_step``: the O(1) decode update of (conv window, ssm state).

Jamba's inner RMSNorm on the SSM branch is included.  d_inner =
expand·d_model; the heads are channel-wise (Mamba-1).  Nothing in either
path reads a tensor on the host, so neither syncs.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import ModelConfig, dense_init


def needs_grad(x: torch.Tensor, params: dict) -> bool:
    """A backward pass will follow: grad mode is on and the input or a
    parameter requires grad."""
    return torch.is_grad_enabled() and (
        x.requires_grad or any(t.requires_grad for t in params.values()))


def chunked_recurrence(step, state: torch.Tensor, xs, chunk: int):
    """The reference's checkpointed chunk scan: ``xs`` a tuple of
    time-major (S, ...) tensors, ``step(state, *x_t) -> (state, y_t)`` out
    of place.  Each chunk of ``chunk`` steps runs under a non-reentrant
    checkpoint, so the backward pass keeps only the chunk-boundary states
    and recomputes the rest.  Returns (the final state, ys (S, ...))."""
    from torch.utils.checkpoint import checkpoint

    def chunk_fn(h, *xc):
        ys = []
        for t in range(xc[0].shape[0]):
            h, y = step(h, *(x[t] for x in xc))
            ys.append(y)
        return h, torch.stack(ys)

    outs = []
    for c in range(0, xs[0].shape[0], chunk):
        state, ys = checkpoint(chunk_fn, state,
                               *(x[c:c + chunk] for x in xs),
                               use_reentrant=False, preserve_rng_state=False)
        outs.append(ys)
    return state, torch.cat(outs)


class MambaState(NamedTuple):
    conv: torch.Tensor    # (B, d_conv-1, d_inner) trailing window
    ssm: torch.Tensor     # (B, d_inner, d_state) float32


def _dims(cfg: ModelConfig):
    d_inner = cfg.mamba_expand * cfg.d_model
    dt_rank = max(cfg.d_model // 16, 1)
    return d_inner, dt_rank, cfg.mamba_d_state, cfg.mamba_d_conv


def init_mamba(cfg: ModelConfig, generator, device) -> dict:
    """The reference's leaves and distributions: ``conv_w`` at std 0.5 ×
    the truncated normal, ``dt_proj_b`` = log(expm1(0.01)) and ``A_log``
    = log(1..N) (S4D-real) computed in float32, ``D`` and the inner norm's
    scale ones, ``conv_b`` zeros."""
    D = cfg.d_model
    d_inner, dt_rank, N, Kc = _dims(cfg)
    pd = cfg.pdtype

    def w(shape, scale=None):
        return dense_init(shape, pd, generator, device, scale=scale)

    def full(value):
        return torch.full((d_inner,), value, dtype=pd, device=device)

    a_log = torch.log(torch.arange(1, N + 1, dtype=torch.float32,
                                   device=device))
    dt_b = torch.log(torch.expm1(torch.full((d_inner,), 0.01,
                                            dtype=torch.float32,
                                            device=device)))
    return {
        "in_proj": w((D, 2 * d_inner)),
        "conv_w": w((Kc, d_inner), scale=0.5),
        "conv_b": full(0.0),
        "x_proj": w((d_inner, dt_rank + 2 * N)),
        "dt_proj_w": w((dt_rank, d_inner)),
        "dt_proj_b": dt_b.to(pd),
        "A_log": a_log.expand(d_inner, N).to(pd).contiguous(),
        "D": full(1.0),
        "norm_scale": full(1.0),
        "out_proj": w((d_inner, D)),
    }


def _selective_params(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """x (..., d_inner) -> Δ (..., d_inner), B and C (..., N)."""
    _, dt_rank, N, _ = _dims(cfg)
    proj = x @ p["x_proj"].to(x.dtype)
    dt, Bm, Cm = torch.split(proj, [dt_rank, N, N], dim=-1)
    delta = F.softplus(dt @ p["dt_proj_w"].to(x.dtype)
                       + p["dt_proj_b"].to(x.dtype))
    return delta, Bm, Cm


def _inner_norm(p: dict, y: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    y32 = y.to(torch.float32)
    rms = torch.sqrt(torch.mean(y32 * y32, -1, keepdim=True) + cfg.norm_eps)
    return (y32 / rms * p["norm_scale"].to(torch.float32)).to(y.dtype)


def _finish(p: dict, y: torch.Tensor, xc: torch.Tensor, z: torch.Tensor,
            cfg: ModelConfig) -> torch.Tensor:
    """The skip D·x, the inner norm, the silu(z) gate, the out projection."""
    y = y + xc * p["D"].to(y.dtype)
    y = _inner_norm(p, y, cfg) * F.silu(z)
    return y @ p["out_proj"].to(y.dtype)


def check_time_chunk(S: int, cfg: ModelConfig, time_chunk: int | None):
    """The reference's contract: the sequence splits into chunks of
    min(time_chunk or cfg.time_chunk, S) steps; raises AssertionError, as
    its ``assert`` does, when it does not."""
    ck = min(time_chunk or cfg.time_chunk, S)
    if S % ck:
        raise AssertionError((S, ck))


def mamba_scan(p: dict, xin: torch.Tensor, cfg: ModelConfig,
               time_chunk: int | None = None):
    """Full-sequence pass.  xin (B, S, D) -> (B, S, D) and the final
    ``MambaState``; the chunked, checkpointed form when a backward pass
    will follow (``needs_grad``)."""
    B, S, _ = xin.shape
    d_inner, _, N, Kc = _dims(cfg)
    check_time_chunk(S, cfg, time_chunk)
    grad = needs_grad(xin, p)
    x, z = torch.chunk(xin @ p["in_proj"].to(xin.dtype), 2, dim=-1)

    # causal depthwise conv over time (window Kc), summed as the
    # reference's Python ``sum``: tap 0 first
    xpad = F.pad(x, (0, 0, Kc - 1, 0))
    conv = xpad[:, 0:S] * p["conv_w"][0].to(x.dtype)
    for i in range(1, Kc):
        conv = conv + xpad[:, i:i + S] * p["conv_w"][i].to(x.dtype)
    xc = F.silu(conv + p["conv_b"].to(x.dtype))

    delta, Bm, Cm = _selective_params(p, xc, cfg)
    A = -torch.exp(p["A_log"].to(torch.float32))             # (d_inner, N)
    d32, b32 = delta.to(torch.float32), Bm.to(torch.float32)
    c32 = Cm.to(torch.float32)
    dx = d32 * xc.to(torch.float32)                          # Δ_t·x_t
    h = torch.zeros((B, d_inner, N), dtype=torch.float32, device=xin.device)
    if grad:
        def step(h, d_t, dx_t, b_t, c_t):
            h = torch.addcmul(h * torch.exp(d_t[:, :, None] * A),
                              dx_t[:, :, None], b_t[:, None, :])
            return h, torch.bmm(h, c_t[:, :, None])[..., 0]

        h, ys = chunked_recurrence(
            step, h, tuple(t.transpose(0, 1) for t in (d32, dx, b32, c32)),
            min(time_chunk or cfg.time_chunk, S))
    else:
        ys = torch.empty((S, B, d_inner), dtype=torch.float32,
                         device=xin.device)
        for t in range(S):
            h.mul_(torch.exp(d32[:, t, :, None] * A))
            h.addcmul_(dx[:, t, :, None], b32[:, t, None, :])
            torch.bmm(h, c32[:, t, :, None], out=ys[t, :, :, None])
    out = _finish(p, ys.transpose(0, 1).to(xin.dtype), xc, z, cfg)
    return out, MambaState(conv=x[:, S - (Kc - 1):, :], ssm=h)


def mamba_step(p: dict, xin: torch.Tensor, state: MambaState,
               cfg: ModelConfig):
    """Decode: xin (B, 1, D) -> (B, 1, D) and the new state.  O(1) in the
    context."""
    x, z = torch.chunk(xin @ p["in_proj"].to(xin.dtype), 2, dim=-1)
    window = torch.cat([state.conv.to(x.dtype), x], dim=1)   # (B, Kc, i)
    conv = torch.einsum("bki,ki->bi", window, p["conv_w"].to(x.dtype)) \
        + p["conv_b"].to(x.dtype)
    xc = F.silu(conv)[:, None, :]                            # (B, 1, i)

    delta, Bm, Cm = _selective_params(p, xc, cfg)
    A = -torch.exp(p["A_log"].to(torch.float32))
    dA = torch.exp(delta.to(torch.float32)[:, 0, :, None] * A)
    dBx = (delta * xc).to(torch.float32)[:, 0, :, None] \
        * Bm.to(torch.float32)[:, 0, None, :]
    h = dA * state.ssm + dBx
    y = torch.bmm(h, Cm.to(torch.float32)[:, 0, :, None])[..., 0]
    out = _finish(p, y[:, None, :].to(xin.dtype), xc, z, cfg)
    return out, MambaState(conv=window[:, 1:, :], ssm=h)


def init_mamba_state(cfg: ModelConfig, batch: int, dtype,
                     device) -> MambaState:
    d_inner, _, N, Kc = _dims(cfg)
    return MambaState(
        conv=torch.zeros((batch, Kc - 1, d_inner), dtype=dtype,
                         device=device),
        ssm=torch.zeros((batch, d_inner, N), dtype=torch.float32,
                        device=device))

