"""GQA attention with every variation of the zoo: grouped KV heads, an
optional QKV bias (qwen2), sliding-window masks (mixtral, gemma2's local
layers), the attention-logit softcap (gemma2), RoPE, M-RoPE or no
positional rotation (whisper adds sinusoidal positions at the embedding),
the bidirectional mode (whisper's encoder), cross-attention over a memory
stream (whisper's decoder), and one-token decode against a KV cache (a
ring buffer for sliding-window layers whose cache is no longer than the
window).  Port of ``repro.models.attention``.

The same einsum / softmax steps as the reference, written in torch
(not ``scaled_dot_product_attention``, whose numerics differ): scores in
the activation dtype, the softcap, masked fill with the dtype's most
negative finite value, softmax in float32, probabilities cast back.

Shapes: x (B, S, D); q (B, S, H, Dh); k, v (B, S, Hk, Dh); Hk | H.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.models.common import (ModelConfig, dense_init, mrope_slots,
                                       rope_freqs, rotate, softcap)

Q_CHUNK = 512        # the q-chunked path's rows a chunk


def init_attention(cfg: ModelConfig, generator, device,
                   cross: bool = False) -> dict:
    """wq, wk, wv, wo (and the qkv biases); ``cross`` (whisper's decoder)
    changes nothing, as in the reference."""
    D, H, Hk, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {name: dense_init(shape, cfg.pdtype, generator, device)
         for name, shape in (("wq", (D, H, Dh)), ("wk", (D, Hk, Dh)),
                             ("wv", (D, Hk, Dh)), ("wo", (H, Dh, D)))}
    if cfg.qkv_bias:
        for name, heads in (("bq", H), ("bk", Hk), ("bv", Hk)):
            p[name] = torch.zeros((heads, Dh), dtype=cfg.pdtype,
                                  device=device)
    return p


class KVCache(NamedTuple):
    k: torch.Tensor       # (B, S_max, Hk, Dh)
    v: torch.Tensor       # (B, S_max, Hk, Dh)


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") with w cast to x's dtype."""
    D, H, Dh = w.shape
    return (x @ w.to(x.dtype).reshape(D, H * Dh)).unflatten(-1, (H, Dh))


def _project_q(p: dict, x: torch.Tensor) -> torch.Tensor:
    q = _heads(x, p["wq"])
    return q + p["bq"].to(x.dtype) if "bq" in p else q


def _project_qkv(p: dict, x: torch.Tensor, xkv: torch.Tensor):
    """q from x, k and v from xkv (x itself, or a cross-attention's
    memory)."""
    k, v = _heads(xkv, p["wk"]), _heads(xkv, p["wv"])
    if "bq" in p:
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    return _project_q(p, x), k, v


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd") with wo cast to out's dtype."""
    H, Dh, D = wo.shape
    return out.flatten(-2) @ wo.to(out.dtype).reshape(H * Dh, D)


def make_rope_tables(positions: torch.Tensor, cfg: ModelConfig, dim: int):
    """(cos, sin), each (B, S, dim/2) float32, once a forward.  positions
    (B, S) integers, or (3, B, S) under M-RoPE (each frequency section
    takes its own stream)."""
    inv = rope_freqs(cfg, dim, positions.device)
    if cfg.mrope_sections is not None:
        pos = positions[mrope_slots(cfg, dim // 2, positions.device)]
        pos = torch.movedim(pos, 0, -1).to(torch.float32)    # (B, S, half)
    else:
        pos = positions.to(torch.float32)[..., None]         # (B, S, 1)
    ang = pos * inv
    return torch.cos(ang), torch.sin(ang)


def _pe(q, k, positions, kv_positions, cfg: ModelConfig, use_rope: bool,
        rope_tables=None):
    """RoPE of q at ``positions`` and of k at ``kv_positions`` (the same
    tables when they are the same tensor); with ``use_rope=False`` q and k
    as they are."""
    if not use_rope:
        return q, k
    if rope_tables is None:
        rope_tables = make_rope_tables(positions, cfg, q.shape[-1])
    kv_tables = rope_tables if kv_positions is positions \
        else make_rope_tables(kv_positions, cfg, k.shape[-1])
    q = rotate(q, *rope_tables).to(q.dtype)
    k = rotate(k, *kv_tables).to(k.dtype)
    return q, k


def _scores_mask(scores, q_pos, k_pos, causal: bool, window: int | None,
                 k_valid=None):
    """scores (B, H, Sq, Sk); q_pos (B, Sq), k_pos (B, Sk) absolute.  The
    masked entries take ``finfo(dtype).min``, not -inf, as the
    reference's do."""
    mask = None
    dq = q_pos[:, None, :, None]
    dk = k_pos[:, None, None, :]
    if causal:
        mask = dk <= dq
    if window is not None:
        w = dk > dq - window
        mask = w if mask is None else mask & w
    if k_valid is not None:
        kv = k_valid[:, None, None, :]
        mask = kv if mask is None else mask & kv
    if mask is None:
        return scores
    return torch.where(mask, scores, torch.finfo(scores.dtype).min)


def _attend_dense(q, k, v, cfg: ModelConfig, q_pos, k_pos, causal, window,
                  k_valid=None):
    """GQA: query head h = hk·rep + r attends with kv head hk, the maths of
    the reference's KV-head repeat, here without materialising the
    repeated k and v (the rep query heads of a kv head are stacked along
    the query axis of one batched product)."""
    B, Sq, H, Dh = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    rep = H // Hk
    scale = cfg.query_scale if cfg.query_scale is not None \
        else 1.0 / math.sqrt(Dh)
    qg = (q * scale).reshape(B, Sq, Hk, rep, Dh).permute(0, 2, 3, 1, 4) \
        .reshape(B, Hk, rep * Sq, Dh)
    scores = (qg @ k.permute(0, 2, 3, 1)).reshape(B, H, Sq, Sk)
    scores = softcap(scores, cfg.attn_logit_softcap)
    scores = _scores_mask(scores, q_pos, k_pos, causal, window, k_valid)
    probs = torch.softmax(scores.to(torch.float32), dim=-1).to(q.dtype)
    out = probs.reshape(B, Hk, rep * Sq, Sk) @ v.permute(0, 2, 1, 3)
    return out.reshape(B, Hk, rep, Sq, Dh).permute(0, 3, 1, 2, 4) \
        .reshape(B, Sq, H, Dh)


def _attend(q, k, v, cfg: ModelConfig, q_pos, k_pos, causal, window,
            k_valid=None):
    """Dense scores for short Sq; above ``cfg.q_chunk_threshold`` (and Sq a
    multiple of 512) one 512-row chunk of queries at a time, so the live
    scores are O(B·H·512·Sk)."""
    Sq = q.shape[1]
    if Sq <= cfg.q_chunk_threshold or Sq % Q_CHUNK != 0:
        return _attend_dense(q, k, v, cfg, q_pos, k_pos, causal, window,
                             k_valid)
    return torch.cat([
        _attend_dense(q[:, i:i + Q_CHUNK], k, v, cfg, q_pos[:, i:i + Q_CHUNK],
                      k_pos, causal, window, k_valid)
        for i in range(0, Sq, Q_CHUNK)], dim=1)


def attention(p: dict, x: torch.Tensor, cfg: ModelConfig, *, positions,
              layer_kind: str = "attn", causal: bool = True,
              use_rope: bool = True, xkv=None, kv_positions=None,
              k_valid=None, rope_tables=None):
    """Full-sequence attention: causal self-attention (training, prefill),
    bidirectional (``causal=False``, whisper's encoder) or cross-attention
    over the memory ``xkv`` (B, Sk, D) (whisper's decoder).

    ``positions`` drive the RoPE of q ((3, B, S) under M-RoPE),
    ``kv_positions`` (default ``positions``) that of k; the MASK always
    uses the plain slot indices 0..Sq-1 and 0..Sk-1, and ``k_valid``
    (B, Sk) masks keys out.  Returns (B, S, D) and the (k, v) of the cache,
    k rotated."""
    xkv = x if xkv is None else xkv
    kv_positions = positions if kv_positions is None else kv_positions
    q, k, v = _project_qkv(p, x, xkv)
    q, k = _pe(q, k, positions, kv_positions, cfg, use_rope, rope_tables)
    B, Sq, Sk = x.shape[0], x.shape[1], xkv.shape[1]
    mask_q = torch.arange(Sq, dtype=torch.int32,
                          device=x.device)[None].expand(B, Sq)
    mask_k = mask_q if Sk == Sq else torch.arange(
        Sk, dtype=torch.int32, device=x.device)[None].expand(B, Sk)
    window = cfg.sliding_window if layer_kind == "swa" else None
    out = _attend(q, k, v, cfg, mask_q, mask_k, causal, window, k_valid)
    return _out_proj(out, p["wo"]), KVCache(k, v)


def ring_mode(cfg: ModelConfig, layer_kind: str, s_max: int) -> bool:
    """A sliding-window layer whose cache holds no more than the window
    keeps it as a ring: token ``pos`` writes slot ``pos % s_max``."""
    return (layer_kind == "swa" and cfg.sliding_window is not None
            and s_max <= cfg.sliding_window)


def write_slot(buf: torch.Tensor, new: torch.Tensor,
               slot: torch.Tensor) -> torch.Tensor:
    """buf (B, S_max, Hk, Dh) with row b's slot ``slot[b]`` replaced by
    new (B, 1, Hk, Dh); a slot outside [0, S_max) writes nowhere.  Equal
    on finite values to the reference's one-hot blend
    buf·(1 − oh) + new·oh (which would also turn a -0.0 it keeps into
    +0.0), in one select."""
    hit = torch.arange(buf.shape[1], device=buf.device)[None] == slot[:, None]
    return torch.where(hit[:, :, None, None], new.to(buf.dtype), buf)


def decode_attention(p: dict, x: torch.Tensor, cache: KVCache,
                     pos: torch.Tensor, cfg: ModelConfig, *,
                     layer_kind: str = "attn", use_rope: bool = True):
    """One-token decode against a cache.

    x (B, 1, D); pos (B,) integer absolute position of the new token
    ((3, B) under M-RoPE, whose first stream picks the slot).  A full
    cache writes slot ``pos`` (at ``pos >= S_max`` nowhere, as the
    reference's one-hot row is then zero) and masks slots past ``pos``;
    a ring (``ring_mode``) writes slot ``pos % S_max`` and rebuilds each
    slot's absolute position as pos − ((pos − slot) mod S_max), the slots
    never written (< 0) masked and no window applied (residency is the
    window).  ``use_rope=False`` (whisper) leaves q and k unrotated.
    Returns (out (B, 1, D), the new cache)."""
    B = x.shape[0]
    S_max = cache.k.shape[1]
    if cfg.mrope_sections is not None:
        positions, scalar_pos = pos[:, :, None], pos[0]
    else:
        positions, scalar_pos = pos[:, None], pos
    q, k_new, v_new = _project_qkv(p, x, x)
    q, k_new = _pe(q, k_new, positions, positions, cfg, use_rope)

    ring = ring_mode(cfg, layer_kind, S_max)
    slot = scalar_pos % S_max if ring else scalar_pos
    k = write_slot(cache.k, k_new, slot)
    v = write_slot(cache.v, v_new, slot)

    idx = torch.arange(S_max, dtype=scalar_pos.dtype, device=x.device)[None]
    if ring:
        k_pos = scalar_pos[:, None] - torch.remainder(
            scalar_pos[:, None] - idx, S_max)
        k_valid = k_pos >= 0
        window = None
    else:
        k_pos = idx.expand(B, S_max)
        k_valid = k_pos <= scalar_pos[:, None]
        window = cfg.sliding_window if layer_kind == "swa" else None
    out = _attend(q, k.to(x.dtype), v.to(x.dtype), cfg, scalar_pos[:, None],
                  k_pos, False, window, k_valid)
    return _out_proj(out, p["wo"]), KVCache(k, v)
