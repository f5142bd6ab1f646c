"""Whisper (tiny), an encoder-decoder with a stubbed conv/audio front end.
Port of ``repro.models.whisper``.

The batch carries precomputed log-mel FRAME EMBEDDINGS (B, T_enc, D) (the
two conv layers + GELU that would produce them are the stub), so the
encoder is the bidirectional transformer stack and the decoder a causal LM
with cross-attention over the encoder's memory.  LayerNorm, a GELU MLP
(jax's default tanh approximation), MHA, sinusoidal absolute positions
for both stacks, decoder embeddings tied to the LM head: the reference's
choices.

Parameters are held one dict a layer: ``params["enc"][l]`` and
``params["dec"][l]`` (the reference stacks them over layers and scans).
The serving cache holds one self-attention ``KVCache`` a decoder layer and
the cross-attention K/V of the memory, computed once in ``prefill``.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models import attention as attn
from repro_torch.models.transformer import token_nll
from repro_torch.models.common import (ModelConfig, apply_norm, dense_init,
                                       logical_to_pspec, module_axes,
                                       pspec_tree, init_norm,
                                       sinusoidal_positions)


def _init_gelu_mlp(cfg: ModelConfig, generator, device) -> dict:
    D, Fd, pd = cfg.d_model, cfg.d_ff, cfg.pdtype
    return {"w_up": dense_init((D, Fd), pd, generator, device),
            "b_up": torch.zeros((Fd,), dtype=pd, device=device),
            "w_down": dense_init((Fd, D), pd, generator, device),
            "b_down": torch.zeros((D,), dtype=pd, device=device)}


def _gelu_mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    h = x @ p["w_up"].to(x.dtype) + p["b_up"].to(x.dtype)
    h = F.gelu(h, approximate="tanh")
    return h @ p["w_down"].to(x.dtype) + p["b_down"].to(x.dtype)


def _init_enc_layer(cfg: ModelConfig, generator, device) -> dict:
    return {"norm1": init_norm(cfg, device),
            "self": attn.init_attention(cfg, generator, device),
            "norm2": init_norm(cfg, device),
            "mlp": _init_gelu_mlp(cfg, generator, device)}


def _init_dec_layer(cfg: ModelConfig, generator, device) -> dict:
    return {"norm1": init_norm(cfg, device),
            "self": attn.init_attention(cfg, generator, device),
            "norm_x": init_norm(cfg, device),
            "cross": attn.init_attention(cfg, generator, device, cross=True),
            "norm2": init_norm(cfg, device),
            "mlp": _init_gelu_mlp(cfg, generator, device)}


def init_params(cfg: ModelConfig, generator: torch.Generator | None,
                device) -> dict:
    """Random parameters in ``cfg.param_dtype`` on ``device`` from
    ``generator`` (None on ``meta``): the reference's shapes and
    distributions, one dict a layer."""
    return {
        "embed": dense_init((cfg.vocab_size, cfg.d_model), cfg.pdtype,
                            generator, device, scale=0.02),
        "enc": [_init_enc_layer(cfg, generator, device)
                for _ in range(cfg.encoder_layers)],
        "dec": [_init_dec_layer(cfg, generator, device)
                for _ in range(cfg.num_layers)],
        "enc_norm": init_norm(cfg, device),
        "dec_norm": init_norm(cfg, device),
    }


_LAYER_MODULES = {"self": "attention", "cross": "attention",
                  "mlp": "gelu_mlp"}


@functools.lru_cache(maxsize=None)
def abstract_params(cfg: ModelConfig):
    """(parameters on ``meta``, logical-axes tree of the same structure)."""
    params = init_params(cfg, None, torch.device("meta"))

    def layer(p):
        return {k: module_axes(_LAYER_MODULES.get(k, "norm"), v)
                for k, v in p.items()}
    return params, {
        "embed": ("vocab", "embed"),
        "enc": [layer(p) for p in params["enc"]],
        "dec": [layer(p) for p in params["dec"]],
        "enc_norm": module_axes("norm", params["enc_norm"]),
        "dec_norm": module_axes("norm", params["dec_norm"])}


def param_pspecs(cfg: ModelConfig, rules=None):
    """PartitionSpec tree of the parameters (their structure)."""
    return pspec_tree(abstract_params(cfg)[1], rules)


@functools.lru_cache(maxsize=16)
def position_table(seq: int, dim: int, device: torch.device) -> torch.Tensor:
    """``sinusoidal_positions(seq, dim)`` on ``device``, built once for each
    (seq, dim, device): a decode step reads it with no host → device
    copy."""
    return sinusoidal_positions(seq, dim, device)


def _slots(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device)[None] \
        .expand(B, S)


def _embed_tokens(params, tokens: torch.Tensor, cfg: ModelConfig):
    return params["embed"][tokens.long()].to(cfg.adtype)


def encode(params, frames: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """frames (B, T_enc, D) stub embeddings -> the encoder's memory
    (B, T_enc, D)."""
    x = frames.to(cfg.adtype)
    B, S = x.shape[0], x.shape[1]
    x = x + position_table(S, cfg.d_model, x.device).to(x.dtype)
    positions = _slots(B, S, x.device)
    for p in params["enc"]:
        h = apply_norm(p["norm1"], x, cfg)
        out, _ = attn.attention(p["self"], h, cfg, positions=positions,
                                causal=False, use_rope=False)
        x = x + out
        h = apply_norm(p["norm2"], x, cfg)
        x = x + _gelu_mlp(p["mlp"], h)
    return apply_norm(params["enc_norm"], x, cfg)


def _decoder(params, tokens: torch.Tensor, memory: torch.Tensor,
             cfg: ModelConfig):
    """The teacher-forced decoder stack: (final hidden states, each layer's
    self-attention (k, v), each layer's cross (k, v))."""
    x = _embed_tokens(params, tokens, cfg)
    B, S = x.shape[0], x.shape[1]
    x = x + position_table(S, cfg.d_model, x.device).to(x.dtype)
    positions = _slots(B, S, x.device)
    mem_pos = _slots(B, memory.shape[1], x.device)
    self_kv, cross_kv = [], []
    for p in params["dec"]:
        h = apply_norm(p["norm1"], x, cfg)
        out, kv = attn.attention(p["self"], h, cfg, positions=positions,
                                 causal=True, use_rope=False)
        x = x + out
        h = apply_norm(p["norm_x"], x, cfg)
        out, xkv = attn.attention(p["cross"], h, cfg, positions=positions,
                                  causal=False, use_rope=False, xkv=memory,
                                  kv_positions=mem_pos)
        x = x + out
        h = apply_norm(p["norm2"], x, cfg)
        x = x + _gelu_mlp(p["mlp"], h)
        self_kv.append(kv)
        cross_kv.append(xkv)
    return apply_norm(params["dec_norm"], x, cfg), self_kv, cross_kv


def _logits(params, x: torch.Tensor) -> torch.Tensor:
    return x @ params["embed"].T.to(x.dtype)


def decode_full(params, tokens, memory, cfg: ModelConfig) -> torch.Tensor:
    """Teacher-forced decoder pass.  tokens (B, S); memory (B, T_enc, D)."""
    return _logits(params, _decoder(params, tokens, memory, cfg)[0])


def forward(params, batch, cfg: ModelConfig, remat: bool = True):
    """batch {"embeds": (B, T_enc, D) frames, "tokens": (B, S)}.  Returns
    (logits (B, S, V), {}); ``remat`` is the reference's signature."""
    memory = encode(params, batch["embeds"], cfg)
    return decode_full(params, batch["tokens"], memory, cfg), {}


def next_token_loss(params, batch, cfg: ModelConfig, remat: bool = True):
    """The mean shifted next-token NLL in float32; ``batch["mask"]`` is
    not read, as in the reference (ROADMAP.md queue 3), so a data
    filter's mask changes nothing here.  Returns (loss, {"nll": loss})."""
    logits, aux = forward(params, batch, cfg, remat)
    loss = torch.mean(token_nll(logits, batch["labels"]))
    aux["nll"] = loss
    return loss, aux


# --------------------------- serving path ----------------------------------

class WhisperCache(NamedTuple):
    self_kv: list           # a KVCache (B, S_max, H, Dh) a decoder layer
    cross_k: list           # (B, T_enc, H, Dh) a decoder layer
    cross_v: list


def init_cache(cfg: ModelConfig, batch: int, s_max: int,
               device) -> WhisperCache:
    """A zero decoder cache in the activation dtype: ``s_max`` self-attention
    slots and the ``encoder_seq`` cross K/V a decoder layer."""
    def kv(s):
        return torch.zeros((batch, s, cfg.num_kv_heads, cfg.head_dim),
                           dtype=cfg.adtype, device=device)
    L = cfg.num_layers
    return WhisperCache(
        self_kv=[attn.KVCache(kv(s_max), kv(s_max)) for _ in range(L)],
        cross_k=[kv(cfg.encoder_seq) for _ in range(L)],
        cross_v=[kv(cfg.encoder_seq) for _ in range(L)])


def cache_pspecs(cfg: ModelConfig, rules=None) -> WhisperCache:
    """PartitionSpecs of ``init_cache``'s tree: every K/V split as the
    reference's dry run splits them (batch, cache_seq, kv_heads,
    head_dim), without its leading layers entry."""
    kv = logical_to_pspec(("batch", "cache_seq", "kv_heads", "head_dim"),
                          rules)
    L = cfg.num_layers
    return WhisperCache(self_kv=[attn.KVCache(kv, kv) for _ in range(L)],
                        cross_k=[kv] * L, cross_v=[kv] * L)


def prefill(params, batch, cfg: ModelConfig, s_max: int | None = None):
    """Encode the frames, run the prompt tokens, build the decoder cache
    (self K/V padded with zeros to ``s_max`` slots, the cross K/V of the
    memory).  Returns (last-position logits (B, 1, V), cache)."""
    memory = encode(params, batch["embeds"], cfg)
    S = batch["tokens"].shape[1]
    pad = (s_max or S) - S
    x, self_kv, cross_kv = _decoder(params, batch["tokens"], memory, cfg)
    self_kv = [attn.KVCache(*(F.pad(t, (0, 0, 0, 0, 0, pad)) for t in kv))
               if pad > 0 else kv for kv in self_kv]
    return _logits(params, x[:, -1:, :]), WhisperCache(
        self_kv=self_kv, cross_k=[kv.k for kv in cross_kv],
        cross_v=[kv.v for kv in cross_kv])


def decode_step(params, batch, cache: WhisperCache, pos,
                cfg: ModelConfig):
    """One decoder token against (the self cache, the precomputed cross
    K/V).  pos (B,) integers.  A position past the cache's last slot takes
    that slot's sinusoid (the reference's gather clamps the index) and
    writes no slot, as the reference's one-hot write does."""
    x = _embed_tokens(params, batch["tokens"], cfg)
    B = x.shape[0]
    s_max = cache.self_kv[0].k.shape[1]
    pe = position_table(s_max, cfg.d_model, x.device)
    idx = torch.where(pos < 0, pos + s_max, pos).clamp(0, s_max - 1)
    x = x + pe[idx.long()][:, None, :].to(x.dtype)
    mem_pos = _slots(B, cache.cross_k[0].shape[1], x.device)
    new_kv = []
    for p, kv, ck, cv in zip(params["dec"], cache.self_kv, cache.cross_k,
                             cache.cross_v):
        h = apply_norm(p["norm1"], x, cfg)
        out, kv = attn.decode_attention(p["self"], h, kv, pos, cfg,
                                        use_rope=False)
        x = x + out
        new_kv.append(kv)
        h = apply_norm(p["norm_x"], x, cfg)
        # cross-attention reads the precomputed memory K/V directly
        q = attn._project_q(p["cross"], h)
        out = attn._attend(q, ck.to(h.dtype), cv.to(h.dtype), cfg,
                           pos[:, None], mem_pos, False, None)
        x = x + attn._out_proj(out, p["cross"]["wo"])
        h = apply_norm(p["norm2"], x, cfg)
        x = x + _gelu_mlp(p["mlp"], h)
    x = apply_norm(params["dec_norm"], x, cfg)
    return _logits(params, x), cache._replace(self_kv=new_kv)
