"""The port's Mamba block (``repro_torch.models.mamba``) and Jamba's hybrid
(``Arch("jamba_v01_52b")``: 7 Mamba + 1 attention layer a superblock, MoE
at the odd pattern positions) against the reference's, at the reduced
config in float32 on the CPU, on one set of weights (``torch_zoo_helpers``).

Tolerances: ``mamba_scan`` and ``mamba_step`` outputs and states within
rtol 1e-5 / atol 1e-5 of the reference's (float32, sums of 8-256 terms in
another order), the port's scan against its own steps within 2e-6;
logits within rtol / atol 2e-4, the reference's own bound
(``tests/test_archs.py:122``); tokens, guardrail counts and n exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")   # the optional `torch` extra

import torch_zoo_helpers as H  # noqa: E402
from repro.models import mamba as jmb  # noqa: E402
from repro_torch.models import mamba as mb  # noqa: E402
from repro_torch.models.registry import Arch  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

_one_torch_thread = pytest.fixture(autouse=True, scope="module")(
    H.one_torch_thread)

NAME = "jamba_v01_52b"
MOD = dict(rtol=1e-5, atol=1e-5)


def _mixer(seed=4):
    """(port config, reference config, a Mamba mixer of the reduced config
    (d_model 128, d_inner 256, N 8), the same mixer as jax arrays)."""
    a = Arch(NAME, reduced=True)
    cfg = a.cfg
    p = mb.init_mamba(cfg, torch.Generator().manual_seed(seed), "cpu")
    jp = {k: jnp.asarray(v.numpy()) for k, v in p.items()}
    return a.cfg, H.pair(NAME)[0].cfg, p, jp


def test_init_constants():
    cfg, _, p, _ = _mixer()
    d_inner, dt_rank, N, Kc = mb._dims(cfg)
    assert (d_inner, dt_rank, N, Kc) == (256, 8, 8, 4)
    # log(1..N) in float32: torch's log, like XLA's, is within 1 ulp
    np.testing.assert_allclose(
        p["A_log"].numpy(),
        np.broadcast_to(np.log(np.arange(1, N + 1)), (d_inner, N)),
        rtol=2e-7, atol=0)
    np.testing.assert_allclose(
        torch.nn.functional.softplus(p["dt_proj_b"]).numpy(), 0.01,
        rtol=1e-6)
    assert float(p["conv_w"].abs().max()) <= 1.0      # 0.5 × cut at 2


def test_scan_and_step_match_reference():
    """The full-sequence scan (output, conv window, ssm state), then four
    decode steps from the scan's state, against the reference's; and the
    port's scan against its own step-by-step decode from zeros."""
    cfg, jcfg, p, jp = _mixer()
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 12, cfg.d_model)).astype(np.float32)
    y, st = mb.mamba_scan(p, torch.as_tensor(x), cfg)
    jy, jst = jax.jit(lambda q, v: jmb.mamba_scan(q, v, jcfg))(
        jp, jnp.asarray(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **MOD)
    np.testing.assert_allclose(st.conv.numpy(), np.asarray(jst.conv), **MOD)
    np.testing.assert_allclose(st.ssm.numpy(), np.asarray(jst.ssm), **MOD)
    assert st.ssm.dtype == torch.float32 and st.conv.shape == (2, 3, 256)

    jstep = jax.jit(lambda q, v, s: jmb.mamba_step(q, v, s, jcfg))
    nxt = rng.normal(size=(2, 4, cfg.d_model)).astype(np.float32)
    for t in range(4):
        out, st = mb.mamba_step(p, torch.as_tensor(nxt[:, t:t + 1]), st, cfg)
        jout, jst = jstep(jp, jnp.asarray(nxt[:, t:t + 1]), jst)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), **MOD)
        np.testing.assert_allclose(st.ssm.numpy(), np.asarray(jst.ssm),
                                   **MOD)
        np.testing.assert_allclose(st.conv.numpy(), np.asarray(jst.conv),
                                   **MOD)

    st = mb.init_mamba_state(cfg, 2, torch.float32, "cpu")
    steps = []
    for t in range(12):
        out, st = mb.mamba_step(p, torch.as_tensor(x[:, t:t + 1]), st, cfg)
        steps.append(out)
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), y.numpy(),
                               rtol=2e-6, atol=2e-6)


def test_time_chunk_contract_raises_like_the_reference():
    """S must split into chunks of min(time_chunk, S): 12 steps in chunks
    of 5 raise AssertionError in both packages; chunks of 4 or one chunk
    of all 12 give the same result."""
    cfg, jcfg, p, jp = _mixer()
    x = np.random.default_rng(6).normal(
        size=(1, 12, cfg.d_model)).astype(np.float32)
    with pytest.raises(AssertionError):
        jmb.mamba_scan(jp, jnp.asarray(x), jcfg, time_chunk=5)
    with pytest.raises(AssertionError):
        mb.mamba_scan(p, torch.as_tensor(x), cfg, time_chunk=5)
    y4, _ = mb.mamba_scan(p, torch.as_tensor(x), cfg, time_chunk=4)
    y, _ = mb.mamba_scan(p, torch.as_tensor(x), cfg)
    assert torch.equal(y4, y)


def test_jamba_forward_prefill_decode_match_reference():
    """The hybrid's forward logits and MoE aux, prefill and teacher-forced
    decode (Mamba states and the attention layer's KV cache carried)
    against the reference's forward."""
    a, cache = H.forward_prefill_decode(NAME)
    kinds = [type(c).__name__ for c in cache[0]]
    assert kinds == ["MambaState"] * 3 + ["KVCache"] + ["MambaState"] * 4
    assert cache[0][3].k.shape[1] == 12           # padded to s_max


def test_jamba_layers_moe_at_odd_positions():
    from repro_torch.models import transformer as tf
    a = Arch(NAME, reduced=True)
    got = [(i, kind, moe) for r, i, kind, moe in tf.layers(a.cfg)]
    assert got == [(i, "attn" if i == 3 else "mamba", i % 2 == 1)
                   for i in range(8)]
    p = H.pair(NAME)[3]
    assert [b["mlp"]["w_gate"].dim() == 3 for b in p["blocks"][0]] == \
        [i % 2 == 1 for i in range(8)]


def test_generate_matches_reference(monkeypatch):
    """Greedy tokens behind a flat guardrail equal the reference's engine's,
    its counts and n bitwise; one verdict block and the tokens are the
    call's transfers."""
    transfers, gp, _ = H.generate_against_reference(NAME, monkeypatch,
                                                    new=4)
    assert transfers == [[(2, 2), (2, 4)]] * 2
    assert float(gp.state.n) > 2, "the armed second admit inserted a row"
