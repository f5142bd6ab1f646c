"""MLP blocks: the dense SwiGLU and the GShard-style top-k MoE (mixtral,
jamba).  Port of ``repro.models.mlp``; rwkv's squared-relu channel mix is
``models.rwkv6.rwkv_channel``, as in the reference.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import ModelConfig, dense_init


def init_mlp(cfg: ModelConfig, generator, device) -> dict:
    D, Fd = cfg.d_model, cfg.d_ff
    return {name: dense_init(shape, cfg.pdtype, generator, device)
            for name, shape in (("w_gate", (D, Fd)), ("w_up", (D, Fd)),
                                ("w_down", (Fd, D)))}


def mlp(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    g = x @ p["w_gate"].to(x.dtype)
    u = x @ p["w_up"].to(x.dtype)
    return (F.silu(g) * u) @ p["w_down"].to(x.dtype)


def init_moe(cfg: ModelConfig, generator, device) -> dict:
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.moe_num_experts
    return {name: dense_init(shape, cfg.pdtype, generator, device)
            for name, shape in (("router", (D, E)), ("w_gate", (E, D, Fd)),
                                ("w_up", (E, D, Fd)), ("w_down", (E, Fd, D)))}


class Routing(NamedTuple):
    logits: torch.Tensor     # (G, Tg, E) float32 router logits
    top_idx: torch.Tensor    # (G, Tg, K) chosen experts, best first
    gates: torch.Tensor      # (G, Tg, K) softmax over the chosen logits
    onehot: torch.Tensor     # (G, Tg, K, E) int32, one-hot of top_idx
    pos: torch.Tensor        # (G, Tg, K) slot in the expert's group buffer
    keep: torch.Tensor       # (G, Tg, K) bool: pos < capacity


def top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` along the last axis: the k largest, ties broken
    toward the lower index (a stable descending sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(p: dict, xt: torch.Tensor, cfg: ModelConfig,
          capacity: int) -> Routing:
    """Top-k routing of xt (G, Tg, D) with a capacity of ``capacity``
    slots an expert a group.  A (token, k) pair's slot is the number of
    pairs before it that chose the same expert, counted over the
    (Tg·K) axis token-major and k-minor (the reference's cumsum,
    ``mlp.py:97-102``): that order decides which pairs are dropped."""
    G, Tg, _ = xt.shape
    E, K = cfg.moe_num_experts, cfg.moe_top_k
    logits = (xt @ p["router"].to(xt.dtype)).to(torch.float32)
    top_val, top_idx = top_k(logits, K)
    gates = torch.softmax(top_val, dim=-1)
    onehot = (top_idx[..., None] == torch.arange(E, device=xt.device)) \
        .to(torch.int32)                                     # (G, Tg, K, E)
    flat = onehot.reshape(G, Tg * K, E)
    before = (torch.cumsum(flat, dim=1) - flat).reshape(G, Tg, K, E)
    pos = torch.sum(before * onehot, dim=-1)
    return Routing(logits, top_idx, gates, onehot, pos, pos < capacity)


def capacity(cfg: ModelConfig, tokens_per_group: int,
             capacity_factor: float | None = None) -> int:
    cf = capacity_factor or cfg.moe_capacity_factor
    return max(int(cf * tokens_per_group * cfg.moe_top_k
                   / cfg.moe_num_experts), 1)


def moe(p: dict, x: torch.Tensor, cfg: ModelConfig,
        capacity_factor: float | None = None, group_size: int = 4096):
    """x (B, S, D) -> (B, S, D) and the aux values ``moe_load_balance``
    and ``moe_drop_frac``.

    The reference's grouped GShard dispatch: the B·S tokens split into
    groups of ``min(group_size, B·S)`` contiguous tokens, each group with
    its own buffer of C = max(int(cf·Tg·K/E), 1) slots an expert; pairs
    past C are dropped; gates are the softmax over the chosen logits.
    Dispatch and combine are dense one-hot products, as in the reference
    (G, Tg, E, C), so at full width they cost O(T·E·C·D)."""
    B, S, D = x.shape
    E = cfg.moe_num_experts
    T = B * S
    Tg = min(group_size, T)
    if T % Tg:
        raise ValueError(f"{T} tokens do not split into groups of {Tg}")
    G = T // Tg
    C = capacity(cfg, Tg, capacity_factor)
    xt = x.reshape(G, Tg, D)
    r = route(p, xt, cfg, C)

    slots = torch.arange(C, device=x.device)
    pos_oh = torch.where(r.keep, r.pos, C)[..., None] == slots   # (G,Tg,K,C)
    disp = torch.einsum("gtke,gtkc->gtec", r.onehot.to(x.dtype),
                        pos_oh.to(x.dtype))
    # one (token, expert) pair holds at most one of the K choices, so the
    # gate-weighted sum over k is exact in any order
    comb = torch.einsum("gtke,gtkc->gtec",
                        r.onehot.to(torch.float32) * r.gates[..., None],
                        pos_oh.to(torch.float32)).to(x.dtype)

    xe = torch.einsum("gtec,gtd->gecd", disp, xt)            # (G, E, C, D)
    g = torch.einsum("gecd,edf->gecf", xe, p["w_gate"].to(x.dtype))
    u = torch.einsum("gecd,edf->gecf", xe, p["w_up"].to(x.dtype))
    ye = torch.einsum("gecf,efd->gecd", F.silu(g) * u,
                      p["w_down"].to(x.dtype))
    out = torch.einsum("gtec,gecd->gtd", comb, ye).reshape(B, S, D)

    # load-balance aux loss (Switch/GShard): E · Σ_e f_e · p_e
    me = torch.mean(torch.softmax(r.logits, dim=-1), dim=(0, 1))
    ce = torch.mean(r.onehot[:, :, 0, :].to(torch.float32), dim=(0, 1))
    aux = {"moe_load_balance": E * torch.sum(me * ce),
           "moe_drop_frac": 1.0 - torch.mean(r.keep.to(torch.float32))}
    return out, aux
