"""The port's whisper (``repro_torch.models.whisper``,
``Arch("whisper_tiny")``) and the attention modes it brings (``repro_torch.models.attention``:
bidirectional, cross-attention, no RoPE, a key mask, decode without RoPE)
against the reference's, at the reduced config in float32 on the CPU, on
one set of weights (``torch_zoo_helpers``).

Tolerances: ``sinusoidal_positions`` bitwise; attention outputs within
rtol 1e-5 / atol 1e-5 and k, v within rtol 1e-5 / atol 1e-6 (those of
``test_torch_models``); logits within rtol / atol 2e-4, the reference's
own bound (``tests/test_archs.py:122``); tokens exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")   # the optional `torch` extra

import torch_zoo_helpers as H  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.models import whisper as wh  # noqa: E402
from repro_torch.serve import engine  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

_one_torch_thread = pytest.fixture(autouse=True, scope="module")(
    H.one_torch_thread)

NAME = "whisper_tiny"


@pytest.mark.parametrize("seq,dim", [(1500, 384), (50, 64), (7, 5),
                                     (3, 2)])
def test_sinusoidal_positions_bitwise(seq, dim):
    got = common.sinusoidal_positions(seq, dim)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jcommon.sinusoidal_positions(seq, dim)))


def _cfgs(name, **kw):
    return (dataclasses.replace(get_config(name, reduced=True), **kw),
            dataclasses.replace(jget_config(name, reduced=True), **kw))


def _attn_params(cfg, rng):
    D, Hh, Hk, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
        cfg.head_dim
    p = {"wq": rng.normal(size=(D, Hh, Dh)) * D ** -0.5,
         "wk": rng.normal(size=(D, Hk, Dh)) * D ** -0.5,
         "wv": rng.normal(size=(D, Hk, Dh)) * D ** -0.5,
         "wo": rng.normal(size=(Hh, Dh, D)) * (Hh * Dh) ** -0.5}
    if cfg.qkv_bias:
        p.update(bq=rng.normal(size=(Hh, Dh)), bk=rng.normal(size=(Hk, Dh)),
                 bv=rng.normal(size=(Hk, Dh)))
    p = {k: v.astype(np.float32) for k, v in p.items()}
    return ({k: torch.as_tensor(v) for k, v in p.items()},
            {k: jnp.asarray(v) for k, v in p.items()})


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


# (mode, attention() keywords): whisper's encoder, its decoder's causal
# self-attention and cross-attention, RoPE on a cross stream, a key mask
MODES = {
    "bidirectional": dict(causal=False, use_rope=False),
    "causal_no_rope": dict(causal=True, use_rope=False),
    "cross": dict(causal=False, use_rope=False, cross=True),
    "cross_rope": dict(causal=False, use_rope=True, cross=True),
    "k_valid": dict(causal=False, use_rope=True, k_valid=True),
}


@pytest.mark.parametrize("name", ["whisper_tiny", "qwen2_1_5b"])
@pytest.mark.parametrize("mode", list(MODES))
def test_attention_modes(name, mode):
    """Every mode of ``attention`` on whisper's MHA and on qwen2's grouped,
    biased heads, against ``repro.models.attention``: a memory of 13
    positions for 9 queries in the cross modes (k positions offset by 5
    under RoPE), a random key mask in the last."""
    kw = dict(MODES[mode])
    cfg, jcfg = _cfgs(name)
    rng = np.random.default_rng(3)
    tp, jp = _attn_params(cfg, rng)
    B, Sq = 2, 9
    x = rng.normal(size=(B, Sq, cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(Sq, dtype=np.int32), (B, 1))
    t_kw, j_kw = {}, {}
    if kw.pop("cross", False):
        mem = rng.normal(size=(B, 13, cfg.d_model)).astype(np.float32)
        mpos = np.tile(np.arange(13, dtype=np.int32) + 5, (B, 1))
        t_kw.update(xkv=torch.as_tensor(mem),
                    kv_positions=torch.as_tensor(mpos))
        j_kw.update(xkv=jnp.asarray(mem), kv_positions=jnp.asarray(mpos))
    if kw.pop("k_valid", False):
        valid = rng.random((B, Sq)) < 0.6
        valid[:, 0] = True
        t_kw["k_valid"] = torch.as_tensor(valid)
        j_kw["k_valid"] = jnp.asarray(valid)
    out, kv = attn.attention(tp, torch.as_tensor(x), cfg,
                             positions=torch.as_tensor(pos), **kw, **t_kw)
    jout, jkv = jattn.attention(jp, jnp.asarray(x), jcfg,
                                positions=jnp.asarray(pos), **kw, **j_kw)
    _close(out, jout, 1e-5, 1e-5)
    _close(kv.k, jkv.k, 1e-5, 1e-6)
    _close(kv.v, jkv.v, 1e-5, 1e-6)


@pytest.mark.parametrize("pos", [[3, 6], [15, 15], [16, 40]])
def test_decode_attention_without_rope(pos):
    """One-token decode against a 16-slot cache with ``use_rope=False``
    (whisper's decoder), at positions inside it and past its end (writes
    nowhere)."""
    cfg, jcfg = _cfgs(NAME)
    rng = np.random.default_rng(5)
    tp, jp = _attn_params(cfg, rng)
    B, s_max = len(pos), 16
    x = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    k = rng.normal(size=(B, s_max, cfg.num_kv_heads,
                         cfg.head_dim)).astype(np.float32)
    v = rng.normal(size=k.shape).astype(np.float32)
    p = np.asarray(pos, np.int32)
    out, cache = attn.decode_attention(
        tp, torch.as_tensor(x), attn.KVCache(torch.as_tensor(k),
                                             torch.as_tensor(v)),
        torch.as_tensor(p), cfg, use_rope=False)
    jout, jcache = jattn.decode_attention(
        jp, jnp.asarray(x), jattn.KVCache(jnp.asarray(k), jnp.asarray(v)),
        jnp.asarray(p), jcfg, use_rope=False)
    _close(out, jout, 1e-5, 1e-5)
    _close(cache.k, jcache.k, 1e-5, 1e-6)
    _close(cache.v, jcache.v, 1e-5, 1e-6)


def test_gelu_is_the_tanh_approximation():
    """jax.nn.gelu's default (tanh), not torch's default erf."""
    from repro.models import whisper as jwh
    x = np.linspace(-6, 6, 97, dtype=np.float32)[None, None]
    p = {"w_up": np.eye(97, dtype=np.float32),
         "b_up": np.zeros(97, np.float32),
         "w_down": np.eye(97, dtype=np.float32),
         "b_down": np.zeros(97, np.float32)}
    got = wh._gelu_mlp({k: torch.as_tensor(v) for k, v in p.items()},
                       torch.as_tensor(x))
    want = jwh._gelu_mlp({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x))
    _close(got, want, 1e-6, 1e-6)
    erf = torch.nn.functional.gelu(torch.as_tensor(x))
    assert float((got - erf).abs().max()) > 1e-4


def test_whisper_forward_prefill_decode_match_reference():
    """forward (encoder over 50 frames, decoder with cross-attention),
    prefill and teacher-forced decode against the reference's forward; the
    cache one self KVCache a decoder layer and the memory's cross K/V."""
    a, cache = H.forward_prefill_decode(NAME)
    cfg = a.cfg
    assert isinstance(cache, wh.WhisperCache)
    assert len(cache.self_kv) == len(cache.cross_k) == cfg.num_layers
    assert cache.self_kv[0].k.shape == (2, 12, cfg.num_heads, cfg.head_dim)
    assert cache.cross_k[0].shape == (2, cfg.encoder_seq, cfg.num_heads,
                                      cfg.head_dim)


def test_decode_past_s_max_matches_reference():
    """Steps at and past the cache's last slot (s_max 10; positions 8-13):
    the reference's gather clamps the sinusoid's index and its one-hot
    write lands nowhere; the port's logits and self caches equal its."""
    ja, jp, a, p = H.pair(NAME)
    batch = H.batch_for(a.cfg, 2, 14, seed=2)
    pre = dict(batch, tokens=batch["tokens"][:, :8])
    _, cache = a.prefill(p, H.as_torch(pre), s_max=10)
    _, jcache = jax.jit(lambda q, b: ja.prefill(q, b, s_max=10))(
        jp, H.as_jax(pre))
    jstep = jax.jit(ja.decode_step)
    for t in range(8, 14):
        tok = batch["tokens"][:, t:t + 1]
        pos = np.full((2,), t, np.int32)
        got, cache = a.decode_step(p, {"tokens": torch.as_tensor(tok)},
                                   cache, torch.as_tensor(pos))
        want, jcache = jstep(jp, {"tokens": jnp.asarray(tok)}, jcache,
                             jnp.asarray(pos))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **H.TOL)
        for layer, kv in enumerate(cache.self_kv):
            np.testing.assert_allclose(kv.k.numpy(),
                                       np.asarray(jcache.self_kv.k[layer]),
                                       rtol=1e-5, atol=1e-5)


def test_position_table_is_built_once():
    wh.position_table.cache_clear()
    a = wh.position_table(16, 64, torch.device("cpu"))
    assert wh.position_table(16, 64, torch.device("cpu")) is a
    assert wh.position_table.cache_info().misses == 1


def test_generate_matches_reference_and_never_admits(monkeypatch):
    """Greedy tokens equal the reference's engine's, decoding past s_max
    (12 prompt tokens, 8 new, s_max 16).  The batch carries "embeds", so
    neither engine calls its guardrail (the reference's rule): n stays 0,
    and the tokens are the call's one transfer."""
    calls = []
    monkeypatch.setattr(jengine.Guardrail, "admit",
                        lambda *a, **k: calls.append("jax"))
    monkeypatch.setattr(engine.Guardrail, "admit",
                        lambda *a, **k: calls.append("torch"))
    transfers, gp, gj = H.generate_against_reference(NAME, monkeypatch,
                                                     new=8)
    assert transfers == [[(2, 8)]] * 2
    assert calls == [] and float(gp.state.n) == float(gj.state.n) == 0
