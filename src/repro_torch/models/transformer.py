"""The decoder-only LM of the zoo, one config-driven implementation of
every layer kind: ``"attn"`` and ``"swa"`` (dense or MoE), ``"mamba"``
(jamba's hybrid, dense or MoE) and ``"rwkv"`` (its own channel mix, never
MoE).  Port of ``repro.models.transformer``; the encoder-decoder whisper
is ``models.whisper``.

Depth is ``cfg.num_superblocks`` repetitions of ``cfg.block_pattern``.
The reference stacks each pattern position's parameters over the
superblocks and scans them; here ``params["blocks"][r][i]`` is the dict of
superblock r's layer at pattern position i, applied in a Python loop.

Entry points (plain functions of dicts of tensors):
    forward(params, batch, cfg)            -> logits, aux   (training)
    next_token_loss(params, batch, cfg)    -> loss, aux     (training)
    prefill(params, batch, cfg, s_max)     -> logits, cache (serving)
    decode_step(params, batch, cache, pos, cfg) -> logits, cache
"""
from __future__ import annotations

import functools

import torch

from repro_torch.models import attention as attn
from repro_torch.models import mamba as mb
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import rwkv6 as rw
from repro_torch.models.common import (ModelConfig, apply_norm, dense_init,
                                       logical_to_pspec, module_axes,
                                       pspec_tree, init_norm, softcap)

ATTENTION_KINDS = ("attn", "swa")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _layer_has_moe(cfg: ModelConfig, pos_in_pattern: int) -> bool:
    """MoE at the pattern positions p with p % period == period − 1 (jamba:
    the odd ones, its attention layer at 3 among them)."""
    if cfg.moe_num_experts is None:
        return False
    return pos_in_pattern % cfg.moe_layer_period == cfg.moe_layer_period - 1


def _init_layer(cfg: ModelConfig, kind: str, use_moe: bool, generator,
                device) -> dict:
    if kind in ATTENTION_KINDS:
        mixer = attn.init_attention(cfg, generator, device)
    elif kind == "mamba":
        mixer = mb.init_mamba(cfg, generator, device)
    elif kind == "rwkv":
        mixer = rw.init_rwkv_time(cfg, generator, device)
    else:
        raise ValueError(f"unknown layer kind {kind!r}")
    if kind == "rwkv":
        mlp = rw.init_rwkv_channel(cfg, generator, device)
    else:
        mlp = (mlp_mod.init_moe if use_moe else mlp_mod.init_mlp)(
            cfg, generator, device)
    p = {"norm1": init_norm(cfg, device), "mixer": mixer,
         "norm2": init_norm(cfg, device), "mlp": mlp}
    if cfg.post_block_norm:   # gemma2 sandwich norms
        p["post_norm1"] = init_norm(cfg, device)
        p["post_norm2"] = init_norm(cfg, device)
    return p


def init_params(cfg: ModelConfig, generator: torch.Generator | None,
                device) -> dict:
    """Random parameters in ``cfg.param_dtype`` on ``device``, drawn from
    ``generator`` (which lives on ``device``; None on ``meta``, where only
    shapes are made).  The same shapes and distributions as the
    reference's ``init_params``; blocks held per superblock."""
    params: dict = {}
    if cfg.input_mode == "tokens":
        # GPT-2-style 0.02 std: keeps tied-head logits O(1) at init.
        params["embed"] = dense_init((cfg.vocab_size, cfg.d_model),
                                     cfg.pdtype, generator, device,
                                     scale=0.02)
    params["blocks"] = [[None] * len(cfg.block_pattern)
                        for _ in range(cfg.num_superblocks)]
    for r, i, kind, use_moe in layers(cfg):
        params["blocks"][r][i] = _init_layer(cfg, kind, use_moe, generator,
                                             device)
    params["final_norm"] = init_norm(cfg, device)
    if cfg.embed_norm:
        params["embed_norm"] = init_norm(cfg, device)
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init((cfg.d_model, cfg.vocab_size),
                                       cfg.pdtype, generator, device)
    return params


def _layer_axes(layer: dict, kind: str, use_moe: bool) -> dict:
    mixer = ("attention" if kind in ATTENTION_KINDS
             else "mamba" if kind == "mamba" else "rwkv_time")
    mlp = ("rwkv_channel" if kind == "rwkv"
           else "moe" if use_moe else "mlp")
    return {k: module_axes(mixer if k == "mixer" else mlp if k == "mlp"
                           else "norm", v) for k, v in layer.items()}


@functools.lru_cache(maxsize=None)
def abstract_params(cfg: ModelConfig):
    """(parameters on ``meta``, logical-axes tree of the same structure):
    shapes only, no allocation."""
    params = init_params(cfg, None, torch.device("meta"))
    logical = {k: module_axes("norm", v) if k.endswith("norm")
               else ("vocab", "embed") if k == "embed"
               else ("embed", "vocab") if k == "lm_head" else None
               for k, v in params.items() if k != "blocks"}
    logical["blocks"] = [[_layer_axes(params["blocks"][r][i], kind, use_moe)
                          for i, kind, use_moe in _pattern(cfg)]
                         for r in range(cfg.num_superblocks)]
    return params, {k: logical[k] for k in params}


def param_pspecs(cfg: ModelConfig, rules=None):
    """PartitionSpec tree of the parameters (their structure)."""
    return pspec_tree(abstract_params(cfg)[1], rules)


def _pattern(cfg: ModelConfig) -> list:
    """(pattern position, kind, use_moe) of one superblock's layers.  An
    rwkv layer is never MoE."""
    return [(i, kind, _layer_has_moe(cfg, i) and kind != "rwkv")
            for i, kind in enumerate(cfg.block_pattern)]


def layers(cfg: ModelConfig):
    """(superblock, pattern position, kind, use_moe) of every layer, in the
    order they run."""
    for r in range(cfg.num_superblocks):
        for i, kind, use_moe in _pattern(cfg):
            yield r, i, kind, use_moe


# ---------------------------------------------------------------------------
# Layer application
# ---------------------------------------------------------------------------

def _apply_layer_full(p, x, kind, use_moe, cfg: ModelConfig, positions,
                      rope_tables=None):
    """Full-sequence layer.  Returns (x, aux, cache entry): a ``KVCache``,
    a ``MambaState`` or rwkv's (x_prev_att, wkv, x_prev_ffn)."""
    aux = {}
    h = apply_norm(p["norm1"], x, cfg)
    if kind in ATTENTION_KINDS:
        out, cache = attn.attention(p["mixer"], h, cfg, positions=positions,
                                    layer_kind=kind, rope_tables=rope_tables)
    elif kind == "mamba":
        out, cache = mb.mamba_scan(p["mixer"], h, cfg)
    else:
        st0 = rw.init_rwkv_state(cfg, x.shape[0], x.dtype, x.device)
        out, xp, wkv = rw.rwkv_time_scan(p["mixer"], h, st0.x_prev_att,
                                         st0.wkv, cfg)
        cache = (xp, wkv)
    if cfg.post_block_norm:
        out = apply_norm(p["post_norm1"], out, cfg)
    x = x + out
    h = apply_norm(p["norm2"], x, cfg)
    if kind == "rwkv":
        out, xp_f = rw.rwkv_channel(p["mlp"], h, torch.zeros_like(h[:, 0]),
                                    cfg)
        cache = cache + (xp_f,)
    elif use_moe:
        out, aux = mlp_mod.moe(p["mlp"], h, cfg)
    else:
        out = mlp_mod.mlp(p["mlp"], h, cfg)
    if cfg.post_block_norm:
        out = apply_norm(p["post_norm2"], out, cfg)
    return x + out, aux, cache


def _apply_layer_decode(p, x, kind, use_moe, cfg: ModelConfig, pos, cache):
    """One-token layer.  Returns (x, new cache entry)."""
    h = apply_norm(p["norm1"], x, cfg)
    if kind in ATTENTION_KINDS:
        out, new_cache = attn.decode_attention(p["mixer"], h, cache, pos,
                                               cfg, layer_kind=kind)
    elif kind == "mamba":
        out, new_cache = mb.mamba_step(p["mixer"], h, cache, cfg)
    else:
        xp_att, wkv, xp_ffn = cache
        out, new_xp, new_wkv = rw.rwkv_time_step(
            p["mixer"], h, rw.RwkvState(xp_att, xp_ffn, wkv), cfg)
    if cfg.post_block_norm:
        out = apply_norm(p["post_norm1"], out, cfg)
    x = x + out
    h = apply_norm(p["norm2"], x, cfg)
    if kind == "rwkv":
        out, new_xpf = rw.rwkv_channel(p["mlp"], h, xp_ffn.to(h.dtype), cfg)
        new_cache = (new_xp, new_wkv, new_xpf.to(xp_ffn.dtype))
    elif use_moe:
        # decode: capacity E/K gives C = T, so no token is ever dropped
        out, _ = mlp_mod.moe(p["mlp"], h, cfg,
                             capacity_factor=float(cfg.moe_num_experts)
                             / cfg.moe_top_k)
    else:
        out = mlp_mod.mlp(p["mlp"], h, cfg)
    if cfg.post_block_norm:
        out = apply_norm(p["post_norm2"], out, cfg)
    return x + out, new_cache


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _embed_scale(d_model: int, dtype: torch.dtype) -> float:
    """sqrt(d_model) rounded to the activation dtype, as the reference
    rounds it; computed once on the host, never a device read."""
    return torch.tensor(float(d_model), dtype=dtype).sqrt().item()


def embed_inputs(params, batch, cfg: ModelConfig) -> torch.Tensor:
    if cfg.input_mode == "tokens":
        x = params["embed"][batch["tokens"].long()].to(cfg.adtype)
    else:
        x = batch["embeds"].to(cfg.adtype)
    if cfg.scale_embeddings:
        x = x * _embed_scale(cfg.d_model, x.dtype)
    if cfg.embed_norm:
        x = apply_norm(params["embed_norm"], x, cfg)
    return x


def lm_head(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return softcap(x @ w.to(x.dtype), cfg.final_logit_softcap)


def _positions_for(batch, cfg: ModelConfig, S: int, B: int, device):
    if cfg.mrope_sections is not None:
        return batch["positions"]            # (3, B, S) from the caller
    return torch.arange(S, dtype=torch.int32, device=device)[None] \
        .expand(B, S)


def _superblock(row, x, aux, cfg: ModelConfig, positions, rope,
                keep_cache: bool):
    """One superblock's layers over the full sequence: (x, aux sums, its
    cache entries, each None unless ``keep_cache``)."""
    caches = []
    for i, kind, use_moe in _pattern(cfg):
        x, a, c = _apply_layer_full(row[i], x, kind, use_moe, cfg, positions,
                                    rope_tables=rope)
        aux = {k: aux[k] + a[k] if k in a else aux[k] for k in aux}
        caches.append(c if keep_cache else None)
    return x, aux, caches


def _run_full(params, batch, cfg: ModelConfig, keep_cache: bool = True,
              checkpoint_kw: dict | None = None):
    """Embed, then every superblock over the full sequence: (x after the
    final norm, aux sums, caches [r][i]).  With ``checkpoint_kw`` each
    superblock runs under ``torch.utils.checkpoint`` with those
    arguments."""
    x = embed_inputs(params, batch, cfg)
    B, S = x.shape[0], x.shape[1]
    positions = _positions_for(batch, cfg, S, B, x.device)
    rope = attn.make_rope_tables(positions, cfg, cfg.head_dim) \
        if cfg.block_pattern != ("rwkv",) else None
    aux = {"moe_load_balance": torch.zeros((), device=x.device),
           "moe_drop_frac": torch.zeros((), device=x.device)} \
        if cfg.moe_num_experts else {}
    caches = []
    for row in params["blocks"]:
        args = (row, x, aux, cfg, positions, rope, keep_cache)
        if checkpoint_kw is None:
            x, aux, c = _superblock(*args)
        else:
            from torch.utils.checkpoint import checkpoint
            x, aux, c = checkpoint(_superblock, *args, **checkpoint_kw)
        caches.append(c)
    return apply_norm(params["final_norm"], x, cfg), aux, caches


# the matmul outputs the "dots" policy saves (jax.checkpoint_policies
# .checkpoint_dots): every product of the zoo lowers to one of these
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def forward(params, batch, cfg: ModelConfig, remat: bool = True,
            remat_policy: str = "full"):
    """batch: {"tokens": (B, S)} or {"embeds": (B, S, D)} (+ "positions"
    (3, B, S) under M-RoPE).  Returns (logits (B, S, V), aux): for MoE the
    sums over layers of ``moe_load_balance`` and ``moe_drop_frac``.

    With ``remat`` and grad mode on, each superblock runs under a
    non-reentrant ``torch.utils.checkpoint``, as the reference checkpoints
    its scan body: ``remat_policy="full"`` saves only the superblock
    boundaries and recomputes the rest in the backward pass; ``"dots"``
    saves the matmul outputs (``aten.mm``, ``bmm``, ``addmm``) and
    recomputes everything else, as ``checkpoint_dots`` does."""
    if remat_policy not in ("full", "dots"):
        raise ValueError(f"unknown remat_policy {remat_policy!r}")
    kw = None
    if remat and torch.is_grad_enabled():
        kw = dict(use_reentrant=False, preserve_rng_state=False)
        if remat_policy == "dots":
            from torch.utils.checkpoint import \
                create_selective_checkpoint_contexts
            kw["context_fn"] = functools.partial(
                create_selective_checkpoint_contexts, _save_dots)
    x, aux, _ = _run_full(params, batch, cfg, keep_cache=False,
                          checkpoint_kw=kw)
    return lm_head(params, x, cfg), aux


def token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Shifted next-token NLL in float32: logsumexp minus the target
    logit at each position but the last, (B, S − 1)."""
    logits = logits[:, :-1, :].to(torch.float32)
    tgt = torch.gather(logits, -1, labels[:, 1:].long()[..., None])[..., 0]
    return torch.logsumexp(logits, dim=-1) - tgt


def next_token_loss(params, batch, cfg: ModelConfig, remat: bool = True,
                    remat_policy: str = "full"):
    """Causal LM loss with shift, masked by ``mask[:, 1:]`` and divided by
    max(Σ mask, 1) (the mean without a mask); MoE adds 0.01 ·
    moe_load_balance / num_layers.  Returns (loss, aux), ``aux["nll"]``
    the loss, as the reference sets it."""
    logits, aux = forward(params, batch, cfg, remat=remat,
                          remat_policy=remat_policy)
    nll = token_nll(logits, batch["labels"])
    mask = batch.get("mask")
    if mask is not None:
        m = mask[:, 1:].to(torch.float32)
        loss = torch.sum(nll * m) / torch.clamp_min(torch.sum(m), 1.0)
    else:
        loss = torch.mean(nll)
    if cfg.moe_num_experts:
        lb = aux["moe_load_balance"]
        loss = loss + 0.01 * lb / torch.full_like(lb, cfg.num_layers)
    aux["nll"] = loss
    return loss, aux


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, s_max: int, device) -> list:
    """Zero caches, ``[r][i]`` as the blocks: KV caches in the activation
    dtype; a ``MambaState`` (conv window in the activation dtype, ssm in
    float32); rwkv's (x_prev_att, wkv float32, x_prev_ffn)."""
    cdt = cfg.adtype
    shape = (batch, s_max, cfg.num_kv_heads, cfg.head_dim)

    def entry(kind):
        if kind in ATTENTION_KINDS:
            return attn.KVCache(
                torch.zeros(shape, dtype=cdt, device=device),
                torch.zeros(shape, dtype=cdt, device=device))
        if kind == "mamba":
            return mb.init_mamba_state(cfg, batch, cdt, device)
        if kind == "rwkv":
            st = rw.init_rwkv_state(cfg, batch, cdt, device)
            return (st.x_prev_att, st.wkv, st.x_prev_ffn)
        raise ValueError(f"unknown layer kind {kind!r}")

    return [[entry(kind) for kind in cfg.block_pattern]
            for _ in range(cfg.num_superblocks)]


def cache_pspecs(cfg: ModelConfig, long_context: bool = False, rules=None):
    """PartitionSpecs of the cache, ``[r][i]`` as ``init_cache``'s: the
    batch on (pod, data); for batch-1 long context the attention cache
    splits its SEQUENCE axis over the data axes instead (context
    parallelism).  The reference's specs without their leading (never
    split) ``"layers"`` entry: the port holds a layer's cache per
    layer."""
    kv = logical_to_pspec(
        (None if long_context else "batch", "cache_seq", "kv_heads",
         "head_dim"), rules)

    def entry(kind):
        if kind in ATTENTION_KINDS:
            return attn.KVCache(kv, kv)
        if kind == "mamba":
            return mb.MambaState(
                conv=logical_to_pspec(("batch", None, "ff"), rules),
                ssm=logical_to_pspec(("batch", "ff", None), rules))
        if kind == "rwkv":
            x = logical_to_pspec(("batch", "embed"), rules)
            return (x, logical_to_pspec(("batch", "heads", None, None),
                                        rules), x)
        raise ValueError(f"unknown layer kind {kind!r}")

    return [[entry(kind) for kind in cfg.block_pattern]
            for _ in range(cfg.num_superblocks)]


def prefill(params, batch, cfg: ModelConfig, s_max: int | None = None):
    """Full-context pass building the cache, its KV caches padded with
    zeros out to ``s_max`` slots (the recurrent states are O(1) and stay
    as they are).  Returns (last-position logits (B, 1, V), cache)."""
    x, _, caches = _run_full(params, batch, cfg)
    S = x.shape[1]
    pad = (s_max or S) - S
    if pad > 0:
        caches = [[attn.KVCache(*(torch.nn.functional.pad(
            t, (0, 0, 0, 0, 0, pad)) for t in c))
            if isinstance(c, attn.KVCache) else c for c in row]
            for row in caches]
    return lm_head(params, x[:, -1:, :], cfg), caches


def decode_step(params, batch, cache, pos, cfg: ModelConfig):
    """One token for the whole batch.  batch {"tokens": (B, 1)} or
    {"embeds": (B, 1, D)}; pos (B,) integers ((3, B) under M-RoPE).
    Returns (logits (B, 1, V), the new cache)."""
    x = embed_inputs(params, batch, cfg)
    new_cache = [[None] * len(cfg.block_pattern)
                 for _ in range(cfg.num_superblocks)]
    for r, i, kind, use_moe in layers(cfg):
        x, new_cache[r][i] = _apply_layer_decode(
            params["blocks"][r][i], x, kind, use_moe, cfg, pos, cache[r][i])
    x = apply_norm(params["final_norm"], x, cfg)
    return lm_head(params, x, cfg), new_cache
