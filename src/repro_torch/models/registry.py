"""Arch registry: an architecture's name -> its config and model functions
(``models.transformer`` for the decoder-only LMs, ``models.whisper`` for
the encoder-decoder), and the dry run's cells.  Port of
``repro.models.registry``.

``input_specs``, ``decode_pos_spec`` and ``cache_specs`` build every
input of a (train | prefill | decode) step as tensors on the ``meta``
device, the counterpart of the reference's ``jax.ShapeDtypeStruct``:
the reference's shapes and dtypes, nothing allocated.  ``all_cells`` is
the dry run's list of (arch, shape) cells.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import resolve_device
from repro_torch.configs import ALIASES, get_config, list_archs
from repro_torch.models import transformer as tf
from repro_torch.models import whisper as wh
from repro_torch.models.common import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

# archs for which long_500k is skipped (pure full attention)
LONG_CONTEXT_SKIP = {
    "mistral_large_123b": "pure full attention (no SWA in 2407 config)",
    "olmo_1b": "pure full attention",
    "qwen2_1_5b": "pure full attention",
    "qwen2_vl_7b": "pure full attention",
    "whisper_tiny": "full-attention decoder; 500k beyond positional design",
}


META = torch.device("meta")


def is_whisper(cfg: ModelConfig) -> bool:
    return cfg.encoder_layers > 0


class Arch:
    """One architecture: its config and step functions."""

    def __init__(self, name: str, reduced: bool = False):
        self.name = ALIASES.get(name, name)
        self.cfg = get_config(name, reduced=reduced)

    # ---- model fns --------------------------------------------------------
    @property
    def mod(self):
        return wh if is_whisper(self.cfg) else tf

    def init_params(self, generator: torch.Generator | int = 0,
                    device=None) -> dict:
        """Random parameters on ``device`` (CUDA unless the caller names
        another), drawn from ``generator`` or a generator seeded with it."""
        device = resolve_device(device)
        if not isinstance(generator, torch.Generator):
            generator = torch.Generator(device=device).manual_seed(
                int(generator))
        return self.mod.init_params(self.cfg, generator, device)

    def forward(self, params, batch, remat=True):
        return self.mod.forward(params, batch, self.cfg, remat=remat)

    def loss(self, params, batch, remat=True, remat_policy="full"):
        """(loss, aux) of the next-token loss; whisper's takes no
        ``remat_policy``, as in the reference."""
        if is_whisper(self.cfg):
            return self.mod.next_token_loss(params, batch, self.cfg,
                                            remat=remat)
        return self.mod.next_token_loss(params, batch, self.cfg,
                                        remat=remat,
                                        remat_policy=remat_policy)

    def prefill(self, params, batch, s_max=None):
        return self.mod.prefill(params, batch, self.cfg, s_max=s_max)

    def decode_step(self, params, batch, cache, pos):
        return self.mod.decode_step(params, batch, cache, pos, self.cfg)

    # ---- shape cells ------------------------------------------------------
    def supports(self, shape_name: str) -> bool:
        return not (shape_name == "long_500k"
                    and self.name in LONG_CONTEXT_SKIP)

    def skip_reason(self, shape_name: str) -> str | None:
        if shape_name == "long_500k":
            return LONG_CONTEXT_SKIP.get(self.name)
        return None

    # ---- sharding ----------------------------------------------------------
    def abstract_params(self):
        """(parameters on ``meta``, their logical-axes tree)."""
        return self.mod.abstract_params(self.cfg)

    def param_pspecs(self, rules=None):
        """PartitionSpec tree of the parameters under ``rules`` (the active
        ones of ``models.common.set_rules`` by default)."""
        return self.mod.param_pspecs(self.cfg, rules)

    # ---- dry-run input specs ---------------------------------------------
    def input_specs(self, shape: ShapeSpec, batch_override: int | None = None
                    ) -> dict:
        """Every model input of a ``shape.kind`` step, on ``meta``: tokens,
        labels and positions int32, embeddings in ``cfg.adtype``."""
        cfg = self.cfg
        B = batch_override or shape.global_batch
        S = shape.seq_len

        def spec(shape_, dtype=torch.int32):
            return torch.empty(shape_, dtype=dtype, device=META)

        if is_whisper(cfg):
            enc = spec((B, cfg.encoder_seq, cfg.d_model), cfg.adtype)
            if shape.kind == "train":
                return {"embeds": enc, "tokens": spec((B, S)),
                        "labels": spec((B, S))}
            if shape.kind == "prefill":
                return {"embeds": enc, "tokens": spec((B, S))}
            return {"tokens": spec((B, 1))}

        if cfg.input_mode == "embeds":   # qwen2-vl backbone
            if shape.kind == "decode":
                out = {"embeds": spec((B, 1, cfg.d_model), cfg.adtype)}
                if cfg.mrope_sections:
                    out["positions"] = spec((3, B, 1))
                return out
            out = {"embeds": spec((B, S, cfg.d_model), cfg.adtype)}
            if cfg.mrope_sections:
                out["positions"] = spec((3, B, S))
            if shape.kind == "train":
                out["labels"] = spec((B, S))
            return out

        if shape.kind == "decode":
            return {"tokens": spec((B, 1))}
        out = {"tokens": spec((B, S))}
        if shape.kind == "train":
            out["labels"] = spec((B, S))
        return out

    def decode_pos_spec(self, shape: ShapeSpec,
                        batch_override: int | None = None) -> torch.Tensor:
        """A decode step's positions on ``meta``: (3, B) under M-RoPE, else
        (B,), int32."""
        B = batch_override or shape.global_batch
        dims = (3, B) if self.cfg.mrope_sections is not None else (B,)
        return torch.empty(dims, dtype=torch.int32, device=META)

    def cache_specs(self, shape: ShapeSpec,
                    batch_override: int | None = None):
        """The decode cache of ``shape`` (``seq_len`` slots) built by
        ``init_cache`` on ``meta``: shapes and dtypes, nothing
        allocated."""
        B = batch_override or shape.global_batch
        return self.mod.init_cache(self.cfg, B, shape.seq_len, META)

    def cache_pspecs(self, long_context: bool = False, rules=None):
        """PartitionSpec tree of ``cache_specs``' cache."""
        if is_whisper(self.cfg):
            return wh.cache_pspecs(self.cfg, rules)
        return tf.cache_pspecs(self.cfg, long_context=long_context,
                               rules=rules)

    # ---- analytics ---------------------------------------------------------
    def _shapes(self) -> dict:
        return self.mod.init_params(self.cfg, None, torch.device("meta"))

    def param_count(self) -> int:
        """Parameters, counted from shapes on the ``meta`` device (nothing
        is allocated)."""
        return sum(t.numel() for t in leaves(self._shapes()))

    def active_param_count(self) -> int:
        """The reference's MoE-aware count of parameters a token uses, by
        its rule: it takes as expert weights the leaves under ``"mlp"``
        whose superblock-stacked shape is 3-D, that is the per-layer 2-D
        ones (the router, or a dense MLP), and scales them by 1 − K/E.
        The expert banks (E, ·, ·) are 4-D stacked and never counted: a
        fault of the reference, copied so the numbers agree (ROADMAP.md
        queue 3 item 13)."""
        total = self.param_count()
        cfg = self.cfg
        if not cfg.moe_num_experts:
            return total
        expert = sum(t.numel() for row in self._shapes()["blocks"]
                     for layer in row for t in layer["mlp"].values()
                     if t.dim() == 2)
        inactive = expert * (1 - cfg.moe_top_k / cfg.moe_num_experts)
        return int(total - inactive)


def leaves(tree):
    """Every tensor of a parameter or cache tree (dicts, lists and tuples,
    the NamedTuple caches among them), dicts in insertion order; ``None``
    is no leaf."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif tree is not None:
        for v in (tree.values() if isinstance(tree, dict) else tree):
            yield from leaves(v)


def tree_map(fn, tree, *rest):
    """``fn`` applied leaf by leaf to ``tree`` and the trees of the same
    structure in ``rest``; the result has ``tree``'s structure (``None``
    stays ``None``)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    out = [tree_map(fn, v, *(r[i] for r in rest))
           for i, v in enumerate(tree)]
    return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)


def unflatten(tree, values):
    """A tree of ``tree``'s structure holding ``values`` in ``leaves``'
    order."""
    it = iter(values)
    return tree_map(lambda _: next(it), tree)


def all_cells(include_skipped: bool = False):
    """Every (arch × shape) cell of the dry run (40 with the skipped
    ones), in the reference's order."""
    out = []
    for arch_name in list_archs():
        a = Arch(arch_name)
        for sname in SHAPES:
            if a.supports(sname) or include_skipped:
                out.append((arch_name, sname))
    return out
