"""The port's model layers (``repro_torch.models``: common, attention, mlp)
against the reference's (``repro.models``) on the same numpy inputs and
weights, in float32 on the CPU.

The reference's functions run jitted (a fifth of their eager compile
time), but for RoPE (see there).  Tolerances: the norms and RoPE are elementwise in float32 and agree within
rtol 1e-6 / atol 1e-6; attention and the MLPs contract in another order
than XLA's products and agree within rtol 1e-5 / atol 1e-6 (atol 1e-5 for
attention outputs, sums of 32-128 products of O(1) terms).  MoE outputs
hold rtol 1e-5 with atol 1e-6 × max|output|: an output that cancels near
zero carries the rounding of its O(max) summands.  The KV write is
the reference's one-hot blend bitwise.  MoE routing (``top_idx``,
``keep``) and ``moe_drop_frac`` are exact, under forced ties and forced
capacity drops.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")   # the optional `torch` extra

from repro.models import attention as jattn  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.models import mlp  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402

jax.config.update("jax_platform_name", "cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: torch's intra-op threads would only
    contend with the other test workers' (several times the run time)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(name, **kw):
    """The reduced config of ``name`` in both packages, with ``kw``."""
    return (dataclasses.replace(get_config(name, reduced=True), **kw),
            dataclasses.replace(jget_config(name, reduced=True), **kw))


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.normal(size=shape)).astype(np.float32)


def _both(tree):
    """A dict of numpy arrays as (torch tensors, jax arrays)."""
    return ({k: torch.as_tensor(v) for k, v in tree.items()},
            {k: jnp.asarray(v) for k, v in tree.items()})


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


def _close_moe(got, want):
    want = np.asarray(want)
    _close(got, want, 1e-5, 1e-6 * max(1.0, float(np.abs(want).max())))


# ---------------------------------------------------------------------------
# common: norms and RoPE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("norm_type", ["rmsnorm", "layernorm",
                                       "nonparam_ln"])
def test_apply_norm(norm_type):
    cfg, jcfg = _cfgs("olmo_1b", norm_type=norm_type)
    rng = np.random.default_rng(0)
    x = _rand(rng, 3, 5, cfg.d_model, scale=2.0) + 0.5
    p = {"scale": _rand(rng, cfg.d_model) + 1.0,
         "bias": _rand(rng, cfg.d_model)}
    p = {k: v for k, v in p.items()
         if k in jcommon.init_norm(jcfg, None)[0]}
    assert set(p) == set(common.init_norm(cfg, "cpu"))
    tp, jp = _both(p)
    _close(common.apply_norm(tp, torch.as_tensor(x), cfg),
           jax.jit(lambda q, y: jcommon.apply_norm(q, y, jcfg))(jp, x),
           1e-6, 1e-6)


def test_apply_rope_and_mrope():
    cfg, jcfg = _cfgs("qwen2_vl_7b", rope_theta=1_000_000.0)
    rng = np.random.default_rng(1)
    x = _rand(rng, 2, 7, 3, cfg.head_dim)
    pos = rng.integers(0, 4000, (2, 7)).astype(np.int32)
    pos3 = rng.integers(0, 4000, (3, 2, 7)).astype(np.int32)
    # eager: jitted, XLA fuses the angle into its own cos/sin, up to 1e-4
    # off the exact ones at these angles (~4000 rad)
    _close(common.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), cfg),
           jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), jcfg),
           1e-6, 1e-6)
    _close(common.apply_mrope(torch.as_tensor(x), torch.as_tensor(pos3),
                              cfg),
           jcommon.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), jcfg),
           1e-6, 1e-6)
    # the tables of a forward: M-RoPE's sections pick their streams
    for c, jc, ps in ((cfg, jcfg, pos3),
                      (dataclasses.replace(cfg, mrope_sections=None),
                       dataclasses.replace(jcfg, mrope_sections=None), pos)):
        got = attn.make_rope_tables(torch.as_tensor(ps), c, c.head_dim)
        want = jattn.make_rope_tables(jnp.asarray(ps), jc, jc.head_dim)
        for g, w in zip(got, want):
            _close(g, w, 1e-6, 1e-6)


def test_softcap():
    x = np.linspace(-300, 300, 101, dtype=np.float32)
    _close(common.softcap(torch.as_tensor(x), 30.0),
           jcommon.softcap(jnp.asarray(x), 30.0), 1e-6, 1e-6)
    assert common.softcap(torch.as_tensor(x), None) is not None


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _attn_params(cfg, rng):
    D, H, Hk, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {"wq": _rand(rng, D, H, Dh, scale=D ** -0.5),
         "wk": _rand(rng, D, Hk, Dh, scale=D ** -0.5),
         "wv": _rand(rng, D, Hk, Dh, scale=D ** -0.5),
         "wo": _rand(rng, H, Dh, D, scale=(H * Dh) ** -0.5)}
    if cfg.qkv_bias:
        p.update(bq=_rand(rng, H, Dh), bk=_rand(rng, Hk, Dh),
                 bv=_rand(rng, Hk, Dh))
    return p


# (config, layer kind, overrides): GQA 4:2 with a window, gemma2's softcap
# and query scale, MHA, qwen2's bias and 6:2 grouping
ATTN_CASES = [
    ("mixtral_8x7b", "swa", {}),
    ("gemma2_27b", "swa", {}),
    ("gemma2_27b", "attn", {}),
    ("olmo_1b", "attn", {}),
    ("qwen2_1_5b", "attn", {}),
    ("mistral_large_123b", "attn", {"sliding_window": 5}),
]


@pytest.mark.parametrize("name,kind,kw", ATTN_CASES,
                         ids=[f"{n}-{k}" for n, k, _ in ATTN_CASES])
def test_attention(name, kind, kw):
    cfg, jcfg = _cfgs(name, **kw)
    rng = np.random.default_rng(2)
    p = _attn_params(cfg, rng)
    tp, jp = _both(p)
    B, S = 2, 21
    x = _rand(rng, B, S, cfg.d_model)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    out, kv = attn.attention(tp, torch.as_tensor(x), cfg,
                             positions=torch.as_tensor(pos), layer_kind=kind)
    jout, jkv = jax.jit(lambda q, y, ps: jattn.attention(
        q, y, jcfg, positions=ps, layer_kind=kind))(jp, x, pos)
    _close(out, jout, 1e-5, 1e-5)
    _close(kv.k, jkv.k, 1e-5, 1e-6)
    _close(kv.v, jkv.v, 1e-5, 1e-6)


def test_attention_q_chunked(monkeypatch):
    """Above q_chunk_threshold, with Sq a multiple of 512, both packages
    attend one 512-row chunk at a time."""
    cfg, jcfg = _cfgs("mixtral_8x7b", q_chunk_threshold=512,
                      sliding_window=700, num_heads=2, num_kv_heads=1,
                      d_model=32, head_dim=16)
    rng = np.random.default_rng(3)
    tp, jp = _both(_attn_params(cfg, rng))
    B, S = 1, 1024
    x = _rand(rng, B, S, cfg.d_model)
    pos = np.arange(S, dtype=np.int32)[None]
    calls = []
    dense = attn._attend_dense

    def counting(q, *a, **k):
        calls.append(q.shape[1])
        return dense(q, *a, **k)

    monkeypatch.setattr(attn, "_attend_dense", counting)
    out, _ = attn.attention(tp, torch.as_tensor(x), cfg,
                            positions=torch.as_tensor(pos), layer_kind="swa")
    assert calls == [512, 512]
    jout, _ = jax.jit(lambda q, y, ps: jattn.attention(
        q, y, jcfg, positions=ps, layer_kind="swa"))(jp, x, pos)
    _close(out, jout, 1e-5, 1e-5)


def test_write_slot_is_the_one_hot_blend_bitwise():
    """The KV write against the reference's one-hot blend on the same
    buffers: ring slots, a wrap, and a slot past S_max that writes
    nowhere — bit for bit."""
    rng = np.random.default_rng(4)
    S_max = 8
    buf = _rand(rng, 5, S_max, 2, 4)
    new = _rand(rng, 5, 1, 2, 4)
    slot = np.array([0, 3, 7, 8, 13], np.int32)    # 8 and 13: past S_max
    got = attn.write_slot(torch.as_tensor(buf), torch.as_tensor(new),
                          torch.as_tensor(slot)).numpy()
    oh = jax.nn.one_hot(jnp.asarray(slot), S_max, dtype=jnp.float32)
    want = np.asarray(jnp.asarray(buf) * (1 - oh[:, :, None, None])
                      + jnp.asarray(new) * oh[:, :, None, None])
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(got[3:], buf[3:])   # nowhere written


# (layer kind, S_max, positions of the new tokens): a full cache, a full
# cache at and past S_max (the write lands nowhere), a ring before and
# after its wrap
DECODE_CASES = [
    ("attn", 12, [3, 11]),
    ("attn", 12, [12, 15]),
    ("swa", 16, [5, 9]),
    ("swa", 16, [21, 40]),
    ("swa", 24, [30, 40]),       # S_max past the window: full cache
]


@pytest.mark.parametrize("kind,s_max,pos", DECODE_CASES)
def test_decode_attention(kind, s_max, pos):
    cfg, jcfg = _cfgs("mixtral_8x7b")          # GQA 4:2, window 16
    rng = np.random.default_rng(5)
    tp, jp = _both(_attn_params(cfg, rng))
    B = len(pos)
    x = _rand(rng, B, 1, cfg.d_model)
    k = _rand(rng, B, s_max, cfg.num_kv_heads, cfg.head_dim)
    v = _rand(rng, B, s_max, cfg.num_kv_heads, cfg.head_dim)
    p = np.asarray(pos, np.int32)
    out, cache = attn.decode_attention(
        tp, torch.as_tensor(x), attn.KVCache(torch.as_tensor(k),
                                             torch.as_tensor(v)),
        torch.as_tensor(p), cfg, layer_kind=kind)
    jout, jcache = jax.jit(lambda q, y, kk, vv, ps: jattn.decode_attention(
        q, y, jattn.KVCache(kk, vv), ps, jcfg, layer_kind=kind))(
        jp, x, k, v, p)
    assert attn.ring_mode(cfg, kind, s_max) == (
        kind == "swa" and s_max <= cfg.sliding_window)
    _close(out, jout, 1e-5, 1e-5)
    _close(cache.k, jcache.k, 1e-5, 1e-6)
    _close(cache.v, jcache.v, 1e-5, 1e-6)
    # every slot but the written one is the old cache, bit for bit
    slot = p % s_max if attn.ring_mode(cfg, kind, s_max) else p
    for b in range(B):
        keep = np.arange(s_max) != slot[b]
        np.testing.assert_array_equal(cache.k.numpy()[b, keep], k[b, keep])


# ---------------------------------------------------------------------------
# MLP and MoE
# ---------------------------------------------------------------------------

def test_mlp():
    cfg, jcfg = _cfgs("olmo_1b")
    rng = np.random.default_rng(6)
    D, F = cfg.d_model, cfg.d_ff
    tp, jp = _both({"w_gate": _rand(rng, D, F, scale=D ** -0.5),
                    "w_up": _rand(rng, D, F, scale=D ** -0.5),
                    "w_down": _rand(rng, F, D, scale=F ** -0.5)})
    x = _rand(rng, 2, 9, D)
    _close(mlp.mlp(tp, torch.as_tensor(x), cfg),
           jax.jit(lambda q, y: jmlp.mlp(q, y, jcfg))(jp, x), 1e-5, 1e-6)


def _moe_case(seed=7):
    """Mixtral's reduced MoE (E 4, top-2) at capacity factor 1.0, so that
    tokens are dropped, with ties: router columns 2 and 3 equal (every
    token ties them) and zero rows (every expert ties)."""
    cfg, jcfg = _cfgs("mixtral_8x7b", moe_capacity_factor=1.0)
    rng = np.random.default_rng(seed)
    D, F, E = cfg.d_model, cfg.d_ff, cfg.moe_num_experts
    router = _rand(rng, D, E)
    router[:, 3] = router[:, 2]
    p = {"router": router, "w_gate": _rand(rng, E, D, F, scale=0.1),
         "w_up": _rand(rng, E, D, F, scale=0.1),
         "w_down": _rand(rng, E, F, D, scale=0.1)}
    x = _rand(rng, 4, 16, D)
    x[1, 3:7] = 0.0
    x[3, :2] = 0.0
    return cfg, jcfg, p, x


def _reference_routing(jp, x, jcfg, C):
    """The reference's routing lines (mlp.py:91-102) on its own logits."""
    G, Tg = 1, x.shape[0] * x.shape[1]
    E, K = jcfg.moe_num_experts, jcfg.moe_top_k

    def lines(router, xt):
        logits = jnp.einsum("gtd,de->gte", xt, router).astype(jnp.float32)
        _, top_idx = jax.lax.top_k(logits, K)
        oh = jax.nn.one_hot(top_idx, E, dtype=jnp.int32)
        flat = oh.reshape(G, Tg * K, E)
        pos = jnp.sum((jnp.cumsum(flat, axis=1) - flat).reshape(G, Tg, K, E)
                      * oh, axis=-1)
        return top_idx, pos < C

    top_idx, keep = jax.jit(lines)(jp["router"], x.reshape(G, Tg, -1))
    return np.asarray(top_idx), np.asarray(keep)


def test_moe_routing_and_drops_exact():
    cfg, jcfg, p, x = _moe_case()
    tp, jp = _both(p)
    T = x.shape[0] * x.shape[1]
    C = mlp.capacity(cfg, T)
    assert C == max(int(1.0 * T * 2 / 4), 1)
    r = mlp.route(tp, torch.as_tensor(x).reshape(1, T, -1), cfg, C)
    top_idx, keep = _reference_routing(jp, x, jcfg, C)
    np.testing.assert_array_equal(r.top_idx.numpy(), top_idx)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    assert not keep.all(), "capacity factor 1.0 must drop here"
    zero_rows = r.top_idx.numpy()[0].reshape(4, 16, 2)[1, 3:7]
    assert (zero_rows == [0, 1]).all(), "ties go to the lower expert"
    chose = r.top_idx.numpy()[0]
    assert not ((chose == 3).any(-1) & ~(chose == 2).any(-1)).any(), \
        "expert 3 ties expert 2 on every token: 3 never wins without 2"

    out, aux = mlp.moe(tp, torch.as_tensor(x), cfg)
    jout, jaux = jax.jit(lambda q, y: jmlp.moe(q, y, jcfg))(jp, x)
    _close_moe(out, jout)
    assert float(aux["moe_drop_frac"]) == float(jaux["moe_drop_frac"])
    assert float(aux["moe_drop_frac"]) > 0
    _close(aux["moe_load_balance"], jaux["moe_load_balance"], 1e-6, 0)


def test_moe_groups_and_decode_capacity():
    """Two groups of 32 tokens with their own buffers, and the decode
    capacity E/K, at which nothing drops."""
    cfg, jcfg, p, x = _moe_case(seed=8)
    tp, jp = _both(p)
    out, aux = mlp.moe(tp, torch.as_tensor(x), cfg, group_size=32)
    jout, jaux = jax.jit(lambda q, y: jmlp.moe(q, y, jcfg, group_size=32))(
        jp, x)
    _close_moe(out, jout)
    assert float(aux["moe_drop_frac"]) == float(jaux["moe_drop_frac"])
    full = float(cfg.moe_num_experts) / cfg.moe_top_k
    out, aux = mlp.moe(tp, torch.as_tensor(x), cfg, capacity_factor=full)
    jout, _ = jax.jit(lambda q, y: jmlp.moe(q, y, jcfg,
                                            capacity_factor=full))(jp, x)
    _close_moe(out, jout)
    assert float(aux["moe_drop_frac"]) == 0.0
