"""The port's RWKV-6 block (``repro_torch.models.rwkv6``) and
``Arch("rwkv6_7b")`` against the reference's, at the reduced config in
float32 on the CPU, on one set of weights (``torch_zoo_helpers``).

RWKV's time-mix ``wo`` and channel-mix ``wv`` are zeros at init (the
official RWKV init), so every block of a fresh model adds exactly 0: a
comparison on the init alone would hold only the embedding, ``ln0`` and
the head (the reference's own ``test_rwkv_scan_equals_stepwise``
compares zeros with zeros).  Every test here redraws them first, std
1/√fan-in, and checks that the blocks then move the output.

Tolerances: the time-mix scan and step outputs and states, and the channel
mix, within rtol 1e-5 / atol 1e-5 of the reference's (float32 sums in
another order); the port's scan against its own steps within 2e-6;
logits within rtol / atol 2e-4, the reference's own bound
(``tests/test_archs.py:122``); tokens, guardrail counts and n exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")   # the optional `torch` extra

import torch_zoo_helpers as H  # noqa: E402
from repro.models import rwkv6 as jrw  # noqa: E402
from repro_torch.models import rwkv6 as rw  # noqa: E402
from repro_torch.models.registry import Arch  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

_one_torch_thread = pytest.fixture(autouse=True, scope="module")(
    H.one_torch_thread)

NAME = "rwkv6_7b"
MOD = dict(rtol=1e-5, atol=1e-5)


def _redrawn(p: dict, name: str, seed: int) -> dict:
    """``p`` with its zero leaf ``name`` drawn at std 1/√fan-in."""
    shape = tuple(p[name].shape)
    w = np.random.default_rng(seed).normal(size=shape) / np.sqrt(shape[0])
    return {**p, name: torch.as_tensor(w.astype(np.float32))}


def _blocks(seed=5):
    """(port config, reference config, time-mix and channel-mix params of
    the reduced config (d_model 128, 8 heads of 16, d_ff 256) with ``wo``
    and ``wv`` redrawn, and each as jax arrays)."""
    a = Arch(NAME, reduced=True)
    cfg = a.cfg
    gen = torch.Generator().manual_seed(seed)
    tp = rw.init_rwkv_time(cfg, gen, "cpu")
    cp = rw.init_rwkv_channel(cfg, gen, "cpu")
    assert not tp["wo"].any() and not cp["wv"].any()
    tp, cp = _redrawn(tp, "wo", seed), _redrawn(cp, "wv", seed + 1)

    def jx(p):
        return {k: jnp.asarray(v.numpy()) for k, v in p.items()}

    return cfg, H.pair(NAME)[0].cfg, tp, cp, jx(tp), jx(cp)


def test_time_scan_and_step_match_reference():
    """The time-mix scan from a nonzero state (output, x_prev, wkv), then
    four decode steps from the scan's state, against the reference's; and
    the port's scan against its own step-by-step decode."""
    cfg, jcfg, tp, _, jtp, _ = _blocks()
    H_, Dh = rw._dims(cfg)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 12, cfg.d_model)).astype(np.float32)
    xp0 = rng.normal(size=(2, cfg.d_model)).astype(np.float32)
    wkv0 = (0.1 * rng.normal(size=(2, H_, Dh, Dh))).astype(np.float32)
    wkv0_t = torch.as_tensor(wkv0)
    y, xp, wkv = rw.rwkv_time_scan(tp, torch.as_tensor(x),
                                   torch.as_tensor(xp0), wkv0_t, cfg)
    assert torch.equal(wkv0_t, torch.as_tensor(wkv0)), "wkv0 not changed"
    jy, jxp, jwkv = jax.jit(lambda q, v, a, b: jrw.rwkv_time_scan(
        q, v, a, b, jcfg))(jtp, jnp.asarray(x), jnp.asarray(xp0),
                           jnp.asarray(wkv0))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **MOD)
    np.testing.assert_array_equal(xp.numpy(), np.asarray(jxp))
    np.testing.assert_allclose(wkv.numpy(), np.asarray(jwkv), **MOD)
    assert float(y.abs().max()) > 0.1, "the redrawn wo moves the output"

    zeros = np.zeros((2, cfg.d_model), np.float32)
    jstep = jax.jit(lambda q, v, s: jrw.rwkv_time_step(q, v, s, jcfg))
    nxt = rng.normal(size=(2, 4, cfg.d_model)).astype(np.float32)
    jxp_, jwkv_ = jxp, jwkv
    for t in range(4):
        out, xp, wkv = rw.rwkv_time_step(
            tp, torch.as_tensor(nxt[:, t:t + 1]),
            rw.RwkvState(xp, torch.as_tensor(zeros), wkv), cfg)
        jout, jxp_, jwkv_ = jstep(jtp, jnp.asarray(nxt[:, t:t + 1]),
                                  jrw.RwkvState(jxp_, jnp.asarray(zeros),
                                                jwkv_))
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), **MOD)
        np.testing.assert_array_equal(xp.numpy(), np.asarray(jxp_))
        np.testing.assert_allclose(wkv.numpy(), np.asarray(jwkv_), **MOD)

    xp, wkv, steps = torch.as_tensor(xp0), wkv0_t, []
    for t in range(12):
        out, xp, wkv = rw.rwkv_time_step(
            tp, torch.as_tensor(x[:, t:t + 1]),
            rw.RwkvState(xp, torch.as_tensor(zeros), wkv), cfg)
        steps.append(out)
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), y.numpy(),
                               rtol=2e-6, atol=2e-6)


def test_group_norm_takes_the_population_variance_and_its_own_eps():
    """``_out_norm`` equals the reference's, also on a head whose 16 values
    are nearly constant, where the eps (64e-5, not ``cfg.norm_eps``) and
    the variance's divisor weigh most."""
    cfg, jcfg, tp, _, jtp, _ = _blocks()
    rng = np.random.default_rng(7)
    y = rng.normal(size=(2, 3, 8, 16)).astype(np.float32)
    y[:, :, 0] = 1.0 + 1e-3 * y[:, :, 0]
    g = rng.normal(size=(2, 3, cfg.d_model)).astype(np.float32)
    got = rw._out_norm(tp, torch.as_tensor(y), torch.as_tensor(g),
                       torch.float32, cfg)
    want = jrw._out_norm(jtp, jnp.asarray(y), jnp.asarray(g), jnp.float32,
                         jcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MOD)
    assert cfg.norm_eps != rw.GROUP_NORM_EPS == 64e-5


def test_channel_mix_matches_reference():
    cfg, jcfg, _, cp, _, jcp = _blocks()
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 12, cfg.d_model)).astype(np.float32)
    xp0 = rng.normal(size=(2, cfg.d_model)).astype(np.float32)
    out, xp = rw.rwkv_channel(cp, torch.as_tensor(x), torch.as_tensor(xp0),
                              cfg)
    jout, jxp = jrw.rwkv_channel(jcp, jnp.asarray(x), jnp.asarray(xp0), jcfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **MOD)
    np.testing.assert_array_equal(xp.numpy(), np.asarray(jxp))
    assert float(out.abs().max()) > 0.1, "the redrawn wv moves the output"


def test_time_chunk_contract_raises_like_the_reference():
    """12 steps in chunks of 5 raise AssertionError in both packages;
    chunks of 4 give the result of one chunk."""
    cfg, jcfg, tp, _, jtp, _ = _blocks()
    x = np.random.default_rng(6).normal(
        size=(1, 12, cfg.d_model)).astype(np.float32)
    st = rw.init_rwkv_state(cfg, 1, torch.float32, "cpu")
    jst = jrw.init_rwkv_state(jcfg, 1, jnp.float32)
    with pytest.raises(AssertionError):
        jrw.rwkv_time_scan(jtp, jnp.asarray(x), jst.x_prev_att, jst.wkv,
                           jcfg, time_chunk=5)
    with pytest.raises(AssertionError):
        rw.rwkv_time_scan(tp, torch.as_tensor(x), st.x_prev_att, st.wkv,
                          cfg, time_chunk=5)
    y4 = rw.rwkv_time_scan(tp, torch.as_tensor(x), st.x_prev_att, st.wkv,
                           cfg, time_chunk=4)[0]
    y = rw.rwkv_time_scan(tp, torch.as_tensor(x), st.x_prev_att, st.wkv,
                          cfg)[0]
    assert torch.equal(y4, y)


def test_rwkv_forward_prefill_decode_match_reference():
    """forward, prefill and teacher-forced decode against the reference's
    forward, with every block's ``wo`` and ``wv`` redrawn; the cache an
    (x_prev_att, wkv float32, x_prev_ffn) a layer.  The blocks move the
    logits: zeroing the redrawn leaves again changes them."""
    a, cache = H.forward_prefill_decode(NAME)
    assert all(len(c) == 3 and c[1].dtype == torch.float32
               and c[1].shape == (2, 8, 16, 16) for row in cache for c in row)
    p = H.pair(NAME)[3]
    tokens = {"tokens": torch.zeros((1, 4), dtype=torch.int32)}
    silent = {**p, "blocks": [[{**b, "mixer": {**b["mixer"],
                                               "wo": 0 * b["mixer"]["wo"]},
                                "mlp": {**b["mlp"], "wv": 0 * b["mlp"]["wv"]}}
                               for b in row] for row in p["blocks"]]}
    moved = a.forward(p, tokens)[0] - a.forward(silent, tokens)[0]
    assert float(moved.abs().max()) > 1e-2


def test_rwkv_takes_no_rope_tables(monkeypatch):
    """A pure-rwkv model builds no RoPE tables (forward and prefill)."""
    from repro_torch.models import attention as attn
    a, p = Arch(NAME, reduced=True), H.pair(NAME)[3]
    monkeypatch.setattr(attn, "make_rope_tables", None)
    tokens = {"tokens": torch.zeros((1, 3), dtype=torch.int32)}
    a.forward(p, tokens)
    a.prefill(p, tokens, s_max=8)


def test_generate_matches_reference(monkeypatch):
    """Greedy tokens behind a flat guardrail equal the reference's engine's,
    its counts and n bitwise; one verdict block and the tokens are the
    call's transfers."""
    transfers, gp, _ = H.generate_against_reference(NAME, monkeypatch,
                                                    new=6)
    assert transfers == [[(2, 2), (2, 6)]] * 2
    assert float(gp.state.n) > 2, "the armed second admit inserted a row"
