"""Shared helpers of the model-zoo parity tests (``test_torch_mamba``,
``test_torch_rwkv``, ``test_torch_whisper``): one set of weights for both
packages, numpy batches, and ``ServeEngine.generate`` held against the
reference's engine.

The weights are the port's own init at a reduced config, written into the
reference's layout (``reference_tree``: each pattern position's leaves
stacked over the superblocks; whisper's encoder and decoder layers each
stacked over its layers) and carried back by ``params_from_reference``, so
both packages compute one function.  RWKV's time-mix ``wo`` and channel-mix
``wv`` are zeros at init, which would silence every RWKV block: the tests
redraw them (``redraw_rwkv_zeros``) before comparing.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models.registry import Arch as JArch
from repro.serve import engine as jengine
from repro_torch.core.convert import params_from_numpy
from repro_torch.models.convert import params_from_reference
from repro_torch.models.registry import Arch
from repro_torch.serve import engine

CPU = torch.device("cpu")
TOL = dict(rtol=2e-4, atol=2e-4)   # the reference's tests/test_archs.py:122
GUARD = dict(num_bits=6, num_tables=8, warmup_items=2.0, alpha=1.0)


def _stack(layers):
    return {k: _stack([x[k] for x in layers])
            if isinstance(layers[0][k], dict)
            else np.stack([x[k].numpy() for x in layers])
            for k in layers[0]}


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.numpy()


def reference_tree(params, cfg):
    """The port's parameters in the reference's layout, as numpy."""
    stacked = {"blocks", "enc", "dec"}
    tree = {k: _numpy(v) for k, v in params.items() if k not in stacked}
    if "blocks" in params:
        tree["blocks"] = [_stack([row[i] for row in params["blocks"]])
                          for i in range(len(cfg.block_pattern))]
    for k in ("enc", "dec"):
        if k in params:
            tree[k] = _stack(params[k])
    return tree


def redraw_rwkv_zeros(tree, cfg, seed: int = 11):
    """Redraw every RWKV block's zero-initialised time-mix ``wo`` (D, D) and
    channel-mix ``wv`` (F, D) in a reference-layout tree, in place: normal
    draws from a numpy generator seeded with ``seed``, std 1/√fan-in."""
    rng = np.random.default_rng(seed)
    for i, kind in enumerate(cfg.block_pattern):
        if kind != "rwkv":
            continue
        blk = tree["blocks"][i]
        for d, name in (blk["mixer"], "wo"), (blk["mlp"], "wv"):
            shape = d[name].shape            # (R, fan-in, D)
            d[name] = (rng.normal(size=shape) / np.sqrt(shape[1])) \
                .astype(np.float32)
    return tree


@functools.lru_cache(maxsize=None)
def pair(name: str, seed: int = 1):
    """(reference Arch, its params as jax arrays, port Arch, the port's
    params) on one set of weights (RWKV's zero leaves redrawn), made once
    a process."""
    ja, a = JArch(name, reduced=True), Arch(name, reduced=True)
    tree = reference_tree(a.init_params(seed, device="cpu"), a.cfg)
    if "rwkv" in a.cfg.block_pattern:
        redraw_rwkv_zeros(tree, a.cfg)
    return (ja, jax.tree.map(jnp.asarray, tree), a,
            params_from_reference(a.cfg, tree, CPU))


def batch_for(cfg, B: int, S: int, seed: int) -> dict:
    """Random prompts (B, S) and, for whisper, frames (B, T_enc, D)."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S))
           .astype(np.int32)}
    if cfg.encoder_layers:
        out["embeds"] = rng.normal(
            size=(B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return out


def as_torch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def as_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def one_torch_thread():
    """The shapes here are tiny: torch's intra-op threads would only
    contend with the other test workers'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def forward_prefill_decode(name: str, B: int = 2, S: int = 12, P: int = 8):
    """forward's logits (and aux) against the reference's forward; prefill
    of P positions and teacher-forced decode of the rest, each position's
    logits against the reference's forward logits there."""
    ja, jp, a, p = pair(name)
    batch = batch_for(a.cfg, B, S, seed=1)
    logits, aux = a.forward(p, as_torch(batch))
    jlogits, jaux = jax.jit(lambda q, b: ja.forward(q, b, remat=False))(
        jp, as_jax(batch))
    jlogits = np.asarray(jlogits)
    np.testing.assert_allclose(logits.numpy(), jlogits, **TOL)
    assert set(aux) == set(jaux)
    for k in aux:
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), **TOL)
    pre = dict(batch, tokens=batch["tokens"][:, :P])
    last, cache = a.prefill(p, as_torch(pre), s_max=S)
    np.testing.assert_allclose(last[:, 0].numpy(), jlogits[:, P - 1], **TOL)
    for t in range(P, S):
        got, cache = a.decode_step(
            p, {"tokens": torch.as_tensor(batch["tokens"][:, t:t + 1])},
            cache, torch.full((B,), t, dtype=torch.int32))
        np.testing.assert_allclose(got[:, 0].numpy(), jlogits[:, t], **TOL)
    return a, cache


def generate_against_reference(name: str, monkeypatch, *, new: int,
                               P: int = 12, s_max: int = 16, B: int = 2):
    """Two ``generate`` calls (the second past the guardrail's warm-up, with
    one prompt of the first again) on the reference's engine with a flat
    guardrail and on the port's with one on the reference's W: tokens
    equal, the guardrail's counts and n bitwise after each call, and the
    port's transfers counted.  Returns the transfers of each port call and
    the two guardrails."""
    ja, jp, a, p = pair(name)
    cfg = a.cfg
    gj = jengine.Guardrail(jengine.GuardrailConfig(d_model=cfg.d_model,
                                                   **GUARD))
    gp = engine.Guardrail(engine.GuardrailConfig(d_model=cfg.d_model,
                                                 **GUARD), device="cpu",
                          w=params_from_numpy(np.asarray(gj.w), CPU))
    jeng = jengine.ServeEngine(ja, s_max=s_max, guardrail=gj)
    eng = engine.ServeEngine(a, s_max=s_max, guardrail=gp, device="cpu")
    calls, orig = [], engine._to_host

    def counting(x):
        calls.append(tuple(x.shape))
        return orig(x)

    monkeypatch.setattr(engine, "_to_host", counting)
    rng = np.random.default_rng(5)
    batch = batch_for(cfg, B, P, seed=4)
    transfers = []
    for call in range(2):
        if call:     # row 0 seen before (admitted once armed), row 1 new
            batch["tokens"][1] = rng.integers(0, cfg.vocab_size, P)
        want = jeng.generate(jp, as_jax(batch), num_new_tokens=new,
                             prompt_len=P)
        del calls[:]
        got = eng.generate(p, batch, num_new_tokens=new, prompt_len=P)
        transfers.append(list(calls))
        assert got.dtype == np.int32 and got.shape == (B, new)
        np.testing.assert_array_equal(got, np.asarray(want))
        np.testing.assert_array_equal(gp.state.counts.numpy(),
                                      np.asarray(gj.state.counts))
        assert float(gp.state.n) == float(gj.state.n)
    return transfers, gp, gj
