"""``ServeEngine.generate`` and ``decode_throughput`` of the port against the
reference's (``repro.serve.engine``), at the reduced configs in float32 on
the CPU, on one set of weights (the port's init stacked into the
reference's layout and carried back by ``params_from_reference``) and,
with a flat guardrail, on the reference's W.

Exact: greedy tokens (with and without a guardrail: its verdict is not
used), the guardrail's counts and n after each call (bitwise), and the
transfers (one ``_to_host`` a call, beside the guardrail's one).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")   # the optional `torch` extra

from repro.models.registry import Arch as JArch  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch.core.convert import params_from_numpy  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.registry import Arch  # noqa: E402
from repro_torch.serve import engine  # noqa: E402

jax.config.update("jax_platform_name", "cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: torch's intra-op threads would only
    contend with the other test workers' (several times the run time)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

CPU = torch.device("cpu")
TOKEN_ARCHS = ["mistral_large_123b", "gemma2_27b", "olmo_1b", "qwen2_1_5b",
               "mixtral_8x7b", "mixtral_8x22b"]
GUARD = dict(num_bits=6, num_tables=8, warmup_items=2.0, alpha=1.0)
B, P, S_MAX = 2, 12, 16


def reference_tree(params, cfg):
    """The port's parameters in the reference's layout, as numpy: each
    pattern position's leaves stacked over the superblocks."""
    def stack(layers):
        return {k: stack([x[k] for x in layers])
                if isinstance(layers[0][k], dict)
                else np.stack([x[k].numpy() for x in layers])
                for k in layers[0]}
    tree = {k: ({kk: vv.numpy() for kk, vv in v.items()}
                if isinstance(v, dict) else v.numpy())
            for k, v in params.items() if k != "blocks"}
    tree["blocks"] = [stack([row[i] for row in params["blocks"]])
                      for i in range(len(cfg.block_pattern))]
    return tree


def _setup(name):
    ja, a = JArch(name, reduced=True), Arch(name, reduced=True)
    tree = reference_tree(a.init_params(2, device="cpu"), a.cfg)
    return ja, jax.tree.map(jnp.asarray, tree), a, \
        params_from_reference(a.cfg, tree, CPU)


def _counting(monkeypatch):
    calls = []
    orig = engine._to_host

    def counting(x):
        calls.append(tuple(x.shape))
        return orig(x)

    monkeypatch.setattr(engine, "_to_host", counting)
    return calls


@pytest.mark.parametrize("name", TOKEN_ARCHS)
def test_generate_matches_reference(name, monkeypatch):
    """Two generate calls (the second past the guardrail's warm-up, with
    one prompt of the first again) on the reference's engine with a flat
    guardrail and the port's with one on the reference's W, the first
    also on the port's with none.  A model of "swa" layers only
    decodes past S_MAX, through the ring's wrap; the others stay inside
    it (an "attn" layer's write past S_MAX lands nowhere)."""
    ja, jp, a, p = _setup(name)
    cfg = a.cfg
    new = 6 if set(cfg.block_pattern) == {"swa"} else S_MAX - P
    gj = jengine.Guardrail(jengine.GuardrailConfig(d_model=cfg.d_model,
                                                   **GUARD))
    gp = engine.Guardrail(engine.GuardrailConfig(d_model=cfg.d_model,
                                                 **GUARD), device="cpu",
                          w=params_from_numpy(np.asarray(gj.w), CPU))
    jeng = jengine.ServeEngine(ja, s_max=S_MAX, guardrail=gj)
    plain = engine.ServeEngine(a, s_max=S_MAX, device="cpu")
    guarded = engine.ServeEngine(a, s_max=S_MAX, guardrail=gp, device="cpu")
    calls = _counting(monkeypatch)
    rng = np.random.default_rng(4)
    prompts = rng.integers(0, cfg.vocab_size, (B, P)).astype(np.int32)
    for call in range(2):
        if call:     # row 0 seen before (admitted once armed), row 1 new
            prompts[1] = rng.integers(0, cfg.vocab_size, P)
        want = jeng.generate(jp, {"tokens": jnp.asarray(prompts)},
                             num_new_tokens=new, prompt_len=P)
        if not call:
            del calls[:]
            got = plain.generate(p, {"tokens": prompts}, num_new_tokens=new,
                                 prompt_len=P)
            assert calls == [(B, new)], "one transfer: the tokens"
            assert got.dtype == np.int32 and got.shape == (B, new)
            np.testing.assert_array_equal(got, np.asarray(want))
        del calls[:]
        got = guarded.generate(p, {"tokens": torch.as_tensor(prompts)},
                               num_new_tokens=new, prompt_len=P)
        assert calls == [(2, B), (B, new)], \
            "the guardrail's verdict block, then the tokens"
        np.testing.assert_array_equal(got, np.asarray(want))
        np.testing.assert_array_equal(gp.state.counts.numpy(),
                                      np.asarray(gj.state.counts))
        assert float(gp.state.n) == float(gj.state.n)
    assert float(gp.state.n) > B, "the armed second admit inserted a row"


def test_embeds_model_cannot_generate():
    """qwen2_vl (input_mode="embeds"): the decode step feeds tokens, and
    both packages fail on the missing embeddings."""
    ja, jp, a, p = _setup("qwen2_vl_7b")
    rng = np.random.default_rng(5)
    batch = {"embeds": rng.normal(size=(B, P, a.cfg.d_model))
             .astype(np.float32),
             "positions": np.tile(np.arange(P, dtype=np.int32), (3, B, 1))}
    with pytest.raises(KeyError, match="embeds"):
        jengine.ServeEngine(ja, s_max=S_MAX).generate(
            jp, {k: jnp.asarray(v) for k, v in batch.items()},
            num_new_tokens=2, prompt_len=P)
    with pytest.raises(KeyError, match="embeds"):
        engine.ServeEngine(a, s_max=S_MAX, device="cpu").generate(
            p, batch, num_new_tokens=2, prompt_len=P)


def test_decode_throughput():
    a = Arch("olmo_1b", reduced=True)
    p = a.init_params(0, device="cpu")
    _, cache = a.prefill(
        p, {"tokens": torch.zeros((B, P), dtype=torch.int32)}, s_max=S_MAX)
    rate = engine.decode_throughput(
        a, p, cache, {"tokens": torch.ones((B, 1), dtype=torch.int32)},
        torch.full((B,), P, dtype=torch.int32), iters=2)
    assert np.isfinite(rate) and rate > 0


def test_no_fallback_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = Arch("olmo_1b", reduced=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        engine.ServeEngine(a)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        a.init_params(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_reference(a.cfg, {})
