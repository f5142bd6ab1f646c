"""Model-zoo substrate: the config schema and the layers every model shares
(initialisers, norms, RoPE / M-RoPE, whisper's sinusoidal positions,
softcap), and the logical-axis sharding rules.  Port of
``repro.models.common``.

Parameters are plain dicts of tensors held in ``cfg.param_dtype``
(float32); activations run in ``cfg.dtype`` and every weight is cast to it
at its point of use, as the reference does.  ``LOGICAL_AXES`` names the
logical axes of every parameter of the zoo (the reference declares them
beside each init), ``logical_to_pspec`` maps them through the active
rules to a ``repro_torch.dist.mesh.PartitionSpec``.  ``shard`` (an
activation's layout hint to GSPMD in the reference) is the identity: the
port gathers each parameter at use and runs the layers whole.  The
reference's XLA barrier (``opt_barrier``) has no counterpart.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One architecture: the reference's fields and defaults, field for
    field (``block_pattern`` is one entry a layer of the superblock:
    ``"attn"``, ``"swa"``, ``"mamba"`` or ``"rwkv"``)."""

    name: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    block_pattern: tuple[str, ...] = ("attn",)

    # attention variations
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int | None = None          # for "swa" layers
    attn_logit_softcap: float | None = None
    final_logit_softcap: float | None = None
    query_scale: float | None = None           # None -> 1/sqrt(head_dim)
    mrope_sections: tuple[int, int, int] | None = None  # qwen2-vl M-RoPE

    # norm / embedding
    norm_type: str = "rmsnorm"     # rmsnorm | layernorm | nonparam_ln
    norm_eps: float = 1e-5
    scale_embeddings: bool = False             # gemma2: x *= sqrt(d_model)
    embed_norm: bool = False                   # rwkv ln0 (post-embedding LN)
    tie_embeddings: bool = False
    post_block_norm: bool = False              # gemma2 sandwich norms

    # MLP / MoE
    mlp_type: str = "swiglu"                   # swiglu | relu2 (rwkv)
    moe_num_experts: int | None = None
    moe_top_k: int = 2
    moe_layer_period: int = 1                  # jamba: MoE every 2nd layer
    moe_capacity_factor: float = 1.25

    # mamba (jamba)
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2

    # rwkv6
    rwkv_head_dim: int = 64
    rwkv_lora_rank: int = 64
    rwkv_decay_lora_rank: int = 64

    # encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 1500                    # whisper frame count (stub)

    # input mode: "tokens" (LM) or "embeds" (vlm/audio frontend stubs)
    input_mode: str = "tokens"

    dtype: str = "bfloat16"
    param_dtype: str = "float32"

    # lowering knobs of the reference (semantics-neutral); the port reads
    # q_chunk_threshold only
    scan_unroll: int = 1
    time_chunk: int = 256
    q_chunk_threshold: int = 8192  # q-chunk attention beyond this Sq
    unroll_q_chunks: bool = False

    @property
    def num_superblocks(self) -> int:
        if self.num_layers % len(self.block_pattern):
            raise ValueError(f"{self.name}: {self.num_layers} layers is not "
                             f"a multiple of the pattern "
                             f"{self.block_pattern}")
        return self.num_layers // len(self.block_pattern)

    @property
    def adtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)


# ---------------------------------------------------------------------------
# Initialisers
# ---------------------------------------------------------------------------

def dense_init(shape, dtype, generator, device, scale: float | None = None):
    """A weight of ``shape``: a standard normal truncated to [-2, 2], times
    ``scale`` or 1/sqrt(shape[0]).

    The fan-in is the FIRST axis whatever the rank, as in the reference
    (``common.py:210-214``): a (E, D, F) expert bank gets std 1/sqrt(E) and
    a (H, Dh, D) output projection 1/sqrt(H).  That is a fault of the
    reference, copied so that both packages draw from one distribution
    (ROADMAP.md queue 3 item 10).  On the ``meta`` device only the shape
    is made."""
    fan_in = shape[0] if len(shape) >= 1 else 1
    std = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    out = torch.empty(shape, dtype=torch.float32, device=device)
    if out.device.type != "meta":
        torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
        out.mul_(std)
    return out.to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_norm(cfg: ModelConfig, device) -> dict:
    """rmsnorm: a scale; layernorm: scale and bias; nonparam_ln (olmo):
    nothing."""
    if cfg.norm_type == "rmsnorm":
        return {"scale": torch.ones(cfg.d_model, dtype=cfg.pdtype,
                                    device=device)}
    if cfg.norm_type == "layernorm":
        return {"scale": torch.ones(cfg.d_model, dtype=cfg.pdtype,
                                    device=device),
                "bias": torch.zeros(cfg.d_model, dtype=cfg.pdtype,
                                    device=device)}
    return {}


def apply_norm(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The norm in float32 (the population variance for the layer norms),
    cast back to ``x``'s dtype."""
    x32 = x.to(torch.float32)
    if cfg.norm_type == "rmsnorm":
        rms = torch.sqrt(torch.mean(x32 * x32, -1, keepdim=True)
                         + cfg.norm_eps)
        out = x32 / rms * p["scale"].to(torch.float32)
    else:
        mu = torch.mean(x32, -1, keepdim=True)
        var = torch.var(x32, -1, keepdim=True, unbiased=False)
        out = (x32 - mu) * torch.rsqrt(var + cfg.norm_eps)
        if cfg.norm_type == "layernorm":
            out = out * p["scale"].to(torch.float32) \
                + p["bias"].to(torch.float32)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE (standard + M-RoPE), rotate-half convention, in float32
# ---------------------------------------------------------------------------

def rope_freqs(cfg: ModelConfig, dim: int, device=None) -> torch.Tensor:
    half = dim // 2
    return 1.0 / (cfg.rope_theta ** (torch.arange(
        half, dtype=torch.float32, device=device) / half))


def rotate(x: torch.Tensor, cos: torch.Tensor,
           sin: torch.Tensor) -> torch.Tensor:
    """Rotate-half of x (B, S, H, D) by angle tables (B, S, D/2), in
    float32 (the caller casts back)."""
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    c = cos[:, :, None, :]
    s = sin[:, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    """x (B, S, H, D), positions (B, S) integers -> x rotated."""
    inv = rope_freqs(cfg, x.shape[-1], x.device)
    ang = positions.to(torch.float32)[..., None] * inv
    return rotate(x, torch.cos(ang), torch.sin(ang)).to(x.dtype)


def mrope_slots(cfg: ModelConfig, half: int, device) -> torch.Tensor:
    """(half,) stream id (0 = t, 1 = h, 2 = w) of each frequency slot: the
    M-RoPE sections, in order."""
    sec = cfg.mrope_sections
    if sec is None or sum(sec) != half:
        raise ValueError(f"mrope_sections {sec} must sum to {half}")
    return torch.cat([torch.full((n,), i, dtype=torch.long, device=device)
                      for i, n in enumerate(sec)])


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE.  positions3 (3, B, S) for (t, h, w): each
    section of the D/2 frequency slots takes its angle from its stream."""
    half = x.shape[-1] // 2
    inv = rope_freqs(cfg, x.shape[-1], x.device)
    pos = positions3[mrope_slots(cfg, half, x.device)]       # (half, B, S)
    ang = torch.movedim(pos, 0, -1).to(torch.float32) * inv
    return rotate(x, torch.cos(ang), torch.sin(ang)).to(x.dtype)


def sinusoidal_positions(seq: int, dim: int, device=None) -> torch.Tensor:
    """Whisper's fixed sinusoidal embeddings (seq, dim) float32: [sin | cos]
    of pos · 10000^(-i / (dim/2 - 1)), built in float64 with numpy as the
    reference builds them and rounded once, so bitwise its table."""
    half = dim // 2
    pos = np.arange(seq)[:, None]
    freq = np.exp(-np.log(10000.0) * np.arange(half) / max(half - 1, 1))
    ang = pos * freq[None, :]
    table = np.concatenate([np.sin(ang), np.cos(ang)], axis=1)
    return torch.as_tensor(table.astype(np.float32), device=device)


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# Logical-axis sharding rules
# ---------------------------------------------------------------------------
# Logical axis vocabulary used across the zoo:
#   batch, seq, embed, heads, kv_heads, head_dim, ff, vocab,
#   experts, capacity, conv, state
DEFAULT_RULES: dict[str, Any] = {
    "batch": ("pod", "data"),
    "seq": None,
    "cache_seq": None,
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "ff": "model",
    "vocab": "model",
    "experts": None,
    "capacity": ("pod", "data"),
    "conv": None,
    "state": None,
    "layers": None,   # the reference's stacked superblock dim — never split
}

_ACTIVE_RULES: dict[str, Any] = dict(DEFAULT_RULES)


def set_rules(rules: dict[str, Any]) -> None:
    """Install the active logical -> mesh rules (the launcher calls this)."""
    _ACTIVE_RULES.clear()
    _ACTIVE_RULES.update(DEFAULT_RULES)
    _ACTIVE_RULES.update(rules)


def get_rules() -> dict[str, Any]:
    return dict(_ACTIVE_RULES)


def logical_to_pspec(axes: tuple, rules: dict[str, Any] | None = None):
    """('embed', 'ff') -> PartitionSpec(None, 'model'), trailing Nones
    trimmed."""
    from repro_torch.dist.mesh import PartitionSpec
    rules = rules if rules is not None else _ACTIVE_RULES
    out = [None if a is None else rules.get(a) for a in axes]
    while out and out[-1] is None:
        out.pop()
    return PartitionSpec(*out)


def shard(x: torch.Tensor, *axes) -> torch.Tensor:
    """An activation's logical layout: the identity (see the module
    docstring)."""
    del axes
    return x


NORM_AXES = {"scale": ("embed",), "bias": ("embed",)}

# One layer's parameters by module, as the reference's inits declare them
# (without its stacked leading "layers" axis: the port holds a layer's
# parameters per layer).
LOGICAL_AXES: dict[str, dict[str, tuple]] = {
    "attention": {
        "wq": ("embed", "heads", "head_dim"),
        "wk": ("embed", "kv_heads", "head_dim"),
        "wv": ("embed", "kv_heads", "head_dim"),
        "wo": ("heads", "head_dim", "embed"),
        "bq": ("heads", "head_dim"),
        "bk": ("kv_heads", "head_dim"),
        "bv": ("kv_heads", "head_dim")},
    "mlp": {"w_gate": ("embed", "ff"), "w_up": ("embed", "ff"),
            "w_down": ("ff", "embed")},
    "moe": {"router": ("embed", "experts"),
            "w_gate": ("experts", "embed", "ff"),
            "w_up": ("experts", "embed", "ff"),
            "w_down": ("experts", "ff", "embed")},
    "gelu_mlp": {"w_up": ("embed", "ff"), "b_up": ("ff",),
                 "w_down": ("ff", "embed"), "b_down": ("embed",)},
    "mamba": {"in_proj": ("embed", "ff"), "conv_w": ("conv", "ff"),
              "conv_b": ("ff",), "x_proj": ("ff", None),
              "dt_proj_w": (None, "ff"), "dt_proj_b": ("ff",),
              "A_log": ("ff", "state"), "D": ("ff",),
              "norm_scale": ("ff",), "out_proj": ("ff", "embed")},
    "rwkv_time": {"mu_x": ("embed",), "mu_rkvwg": (None, "embed"),
                  "tm_w1": ("embed", None), "tm_w2": (None, None, "embed"),
                  "decay_base": ("embed",), "dd_w1": ("embed", None),
                  "dd_w2": (None, "embed"), "bonus_u": ("heads", "head_dim"),
                  "wr": ("embed", "ff"), "wk": ("embed", "ff"),
                  "wv": ("embed", "ff"), "wg": ("embed", "ff"),
                  "wo": ("ff", "embed"), "ln_scale": ("embed",),
                  "ln_bias": ("embed",)},
    "rwkv_channel": {"mu_k": ("embed",), "mu_r": ("embed",),
                     "wk": ("embed", "ff"), "wr": ("embed", "ff"),
                     "wv": ("ff", "embed")},
    "norm": NORM_AXES,
}


def module_axes(module: str, params: dict) -> dict:
    """The logical axes of one module's parameter dict."""
    table = LOGICAL_AXES[module]
    return {k: table[k] for k in params}


def pspec_tree(logical, rules: dict[str, Any] | None = None):
    """A logical-axes tree (dicts and lists of axis tuples) as a tree of
    PartitionSpecs through ``rules`` (the active ones by default)."""
    if isinstance(logical, tuple):
        return logical_to_pspec(logical, rules)
    if isinstance(logical, dict):
        return {k: pspec_tree(v, rules) for k, v in logical.items()}
    return [pspec_tree(v, rules) for v in logical]
