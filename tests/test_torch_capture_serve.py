"""The compile-once contract for serving: the port's ``ServeEngine`` runs its
prefill and its decode step each as one ``core.capture`` program, one
captured CUDA graph a signature, as the reference jits both
(``repro/serve/engine.py:599-601``).

On the CPU a program runs keys, counting, static buffers and copy-in/
copy-out and skips only the capture and the replay
(``tests/test_torch_gpu.py -k captured_serve`` holds the graphs on the
card).  Here, for one reduced float32 model of each family the engine
serves (a dense token model, a Mamba hybrid with an MoE attention layer,
RWKV-6, whisper), on one set of weights for both packages
(``torch_zoo_helpers``):

* after every call of one sequence (two ``generate`` calls of one shape, a
  new ``num_new_tokens``, a new ``prompt_len``, a new batch size, new
  weights of the same shapes, the first weights again) the port's prefill
  and decode ``trace_counts`` equal the reference's
  ``_prefill._cache_size()`` and ``_decode._cache_size()``, and the
  tokens equal the reference's and the eager twin's
  (``capture.disabled()``) exactly;
* the weights are adopted: the programs read the caller's tensors where
  they lie (same ``data_ptr``, no clone), never write them and keep no
  reference to them; weights of the same shapes elsewhere build that key
  again with no program counted, and the tokens follow them;
* a cache handed to ``decode_throughput`` is not written;
* qwen2_vl's ``KeyError: 'embeds'`` surfaces unwrapped, from the decode
  step's warm-up, and the failed build counts one program, as the
  reference's failed trace counts one jit cache entry.

Sizes: two layers a model (the Mamba hybrid one Mamba and one MoE
attention layer; the dense model the reference's own
``tests/test_stream.py:395-402`` cut), B 2-3, prompts of 6-8, s_max 16.
"""
import dataclasses
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")   # the optional `torch` extra

import torch_zoo_helpers as H  # noqa: E402
from repro.models.registry import Arch as JArch  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch.core import capture  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.registry import Arch  # noqa: E402
from repro_torch.serve import engine  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

_one_torch_thread = pytest.fixture(autouse=True, scope="module")(
    H.one_torch_thread)

S_MAX = 16
# (batch, prompt_len, num_new_tokens, weights) of each call in turn
SEQUENCE = [(2, 8, 4, 0), (2, 8, 4, 0), (2, 8, 3, 0), (2, 6, 3, 0),
            (3, 6, 3, 0), (3, 6, 3, 1), (3, 6, 3, 0)]
FAMILIES = {
    "dense": ("qwen2_1_5b", dict(num_layers=2, d_model=64, num_heads=2,
                                 num_kv_heads=2, head_dim=32, d_ff=128,
                                 vocab_size=256)),
    "mamba_hybrid": ("jamba_v01_52b", dict(block_pattern=("mamba", "attn"),
                                           num_layers=2)),
    "rwkv6": ("rwkv6_7b", dict(num_layers=2)),
    "whisper": ("whisper_tiny", {}),
}


def models(family: str, seeds=(1, 2)):
    """(reference Arch, port Arch, [(reference params, port params)] a
    seed): the reduced config cut as ``FAMILIES`` says, in float32, both
    packages on the port's init carried across (RWKV's zero leaves
    redrawn)."""
    name, cut = FAMILIES[family]
    ja, a = JArch(name, reduced=True), Arch(name, reduced=True)
    ja.cfg = dataclasses.replace(ja.cfg, dtype="float32", **cut)
    a.cfg = dataclasses.replace(a.cfg, dtype="float32", **cut)
    weights = []
    for seed in seeds:
        tree = H.reference_tree(a.init_params(seed, device="cpu"), a.cfg)
        if "rwkv" in a.cfg.block_pattern:
            H.redraw_rwkv_zeros(tree, a.cfg, seed=10 + seed)
        weights.append((jax.tree.map(jnp.asarray, tree),
                        params_from_reference(a.cfg, tree, H.CPU)))
    return ja, a, weights


def adopted(program) -> list:
    """Where the graph of a program's latest key reads the weights: each
    leaf's ``data_ptr``."""
    return [w[0] for w in program._last.where[0]]


def ptrs(params) -> list:
    return [t.data_ptr() for t in capture.leaves(params)]


@pytest.mark.parametrize("family", list(FAMILIES))
def test_trace_counts_and_tokens_match_reference(family):
    """The sequence on the reference's engine, the port's and the port's
    eager twin."""
    ja, a, weights = models(family)
    cfg = a.cfg
    jeng = jengine.ServeEngine(ja, s_max=S_MAX)
    eng = engine.ServeEngine(a, s_max=S_MAX, device="cpu")
    twin = engine.ServeEngine(a, s_max=S_MAX, device="cpu")
    kept = [capture.tree_map(torch.clone, p) for _, p in weights]
    for call, (B, P, new, w) in enumerate(SEQUENCE):
        jp, p = weights[w]
        batch = H.batch_for(cfg, B, P, seed=call)
        want = np.asarray(jeng.generate(jp, H.as_jax(batch),
                                        num_new_tokens=new, prompt_len=P))
        got = eng.generate(p, batch, num_new_tokens=new, prompt_len=P)
        with capture.disabled():
            eager = twin.generate(p, batch, num_new_tokens=new,
                                  prompt_len=P)
        what = f"{family} call {call} (B {B}, P {P}, new {new}, weights {w})"
        np.testing.assert_array_equal(got, want, err_msg=what)
        np.testing.assert_array_equal(eager, want, err_msg=what)
        assert eng.trace_counts == (jeng._prefill._cache_size(),
                                    jeng._decode._cache_size()), what
        assert twin.trace_counts == (0, 0), "the eager twin builds nothing"
        # the latest key reads this call's weights where they lie
        for prog in (eng._prefill, eng._decode):
            assert adopted(prog) == ptrs(p), what
    assert eng.trace_counts == (3, 2)
    for (_, p), k in zip(weights, kept):
        assert all(torch.equal(x, y) for x, y in zip(capture.leaves(p),
                                                      capture.leaves(k)))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_weights_adopted_never_written(family):
    """The programs read the caller's weight tensors in place (same
    ``data_ptr``, no clone).  Serving p1, then p2 of the same shapes, then
    p1 again builds each key again on the weights given, with no program
    counted: the tokens equal the eager twin's on each set, and neither
    set is written.  The engine keeps no reference to the weights: a
    caller's ``del`` frees them."""
    _, a, weights = models(family)
    (_, p1), (_, p2) = weights
    kept = [capture.tree_map(torch.clone, p) for p in (p1, p2)]
    batch = H.batch_for(a.cfg, 2, 8, seed=7)
    eng = engine.ServeEngine(a, s_max=S_MAX, device="cpu")
    with capture.disabled():
        want = [eng.generate(p, batch, num_new_tokens=4, prompt_len=8)
                for p in (p1, p2)]
    assert not np.array_equal(*want), "two draws, two answers"
    for i in (0, 1, 0, 0):
        p = (p1, p2)[i]
        np.testing.assert_array_equal(
            eng.generate(p, batch, num_new_tokens=4, prompt_len=8), want[i])
        assert eng.trace_counts == (1, 1), "same shapes: no new program"
        for prog in (eng._prefill, eng._decode):
            assert adopted(prog) == ptrs(p)
    for q, k in zip((p1, p2), kept):
        assert all(torch.equal(x, y) for x, y in zip(capture.leaves(q),
                                                      capture.leaves(k)))
    gone = weakref.ref(capture.leaves(p2)[0])
    weights.clear()
    del p, q, p2
    assert gone() is None, "the engine holds no adopted tensor"


@pytest.mark.parametrize("family", list(FAMILIES))
def test_decode_throughput_leaves_the_cache(family):
    """``decode_throughput`` builds its own program (one key) on a cache
    the caller keeps: every leaf of it unchanged, bit for bit."""
    _, a, weights = models(family, seeds=(1,))
    p = weights[0][1]
    batch = H.as_torch(H.batch_for(a.cfg, 2, 8, seed=3))
    with torch.no_grad():
        logits, cache = a.prefill(p, batch, s_max=S_MAX)
    before = capture.tree_map(torch.clone, cache)
    step = {"tokens": torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]}
    rate = engine.decode_throughput(a, p, cache, step,
                                    torch.full((2,), 8, dtype=torch.int32),
                                    iters=2)
    assert np.isfinite(rate) and rate > 0
    assert all(torch.equal(x, y) for x, y in zip(capture.leaves(cache),
                                                  capture.leaves(before)))


def test_embeds_model_raises_from_the_warm_up():
    """qwen2_vl: the prefill builds, the decode step's warm-up raises the
    reference's ``KeyError`` unwrapped, and the failed build counts one
    program, as the reference's failed trace counts one jit entry."""
    ja, jp, a, p = H.pair("qwen2_vl_7b")
    P = 8
    rng = np.random.default_rng(5)
    batch = {"embeds": rng.normal(size=(2, P, a.cfg.d_model))
             .astype(np.float32),
             "positions": np.tile(np.arange(P, dtype=np.int32), (3, 2, 1))}
    jeng = jengine.ServeEngine(ja, s_max=S_MAX)
    eng = engine.ServeEngine(a, s_max=S_MAX, device="cpu")
    with pytest.raises(KeyError, match="embeds"):
        jeng.generate(jp, H.as_jax(batch), num_new_tokens=2, prompt_len=P)
    with pytest.raises(KeyError, match="embeds"):
        eng.generate(p, batch, num_new_tokens=2, prompt_len=P)
    assert eng.trace_counts == (jeng._prefill._cache_size(),
                                jeng._decode._cache_size()) == (1, 1)


def test_dict_keys_in_any_order_are_one_program():
    """A dict operand is keyed by its sorted keys, as jit's pytrees are:
    the same batch built in another order replays the same program."""
    def fn(state, batch):
        return state + batch["a"] * batch["b"], None

    prog = capture.Program(fn, "cpu", name="dict")
    one = torch.ones(3)
    state, _ = prog(torch.zeros(3), {"a": one, "b": 2 * one})
    state, _ = prog(state, {"b": 3 * one, "a": one})
    assert prog.trace_count == 1
    assert torch.equal(state, torch.full((3,), 5.0))


def test_adopted_input_must_lie_on_the_device():
    prog = capture.Program(lambda s, w: (s, None), "cpu", name="adopt")
    with pytest.raises(ValueError, match="adopted input lies on meta"):
        prog(None, {"w": torch.empty(2, device="meta")}, adopt=(0,))


def test_another_adoption_builds_the_key_again_uncounted():
    """A key built with an input adopted is built again, not counted, when
    a call adopts another tensor there or copies that input in instead (a
    runner's staged chunk, then a caller's); the adopted tensor is read,
    never written."""
    prog = capture.Program(lambda s, x: (s + x, None), "cpu", name="mix")
    staged, other = torch.ones(3), torch.full((3,), 2.0)
    state, _ = prog(torch.zeros(3), staged, adopt=(0,))
    entry = prog._last
    state, _ = prog(state, staged, adopt=(0,))
    assert prog._last is entry, "the same tensor: the same graph"
    state, _ = prog(state, other, adopt=(0,))
    state, _ = prog(state, other)
    assert prog._last is not entry and prog._last.adopt == frozenset()
    state, _ = prog(state, staged)
    assert prog.trace_count == 1
    assert torch.equal(state, torch.full((3,), 7.0))
    assert torch.equal(staged, torch.ones(3))
    assert torch.equal(other, torch.full((3,), 2.0))


def test_new_tensor_at_a_copied_ones_address_is_copied_in():
    """A const leaf's copy-in is keyed by the tensor itself and its
    version, not by its address: a new tensor over the storage a copied
    one holds (as the allocator may place a new tensor where a freed one
    lay), at the same version, is copied in."""
    prog = capture.Program(lambda s, w: (s, w["a"] * 1), "cpu",
                           name="reuse", consts=(0,))
    # version 1, as a tensor made by ``set_`` starts at
    first, second = {"a": torch.zeros(3)}, {"a": torch.zeros(3).add_(1)}
    prog(None, first)
    assert torch.equal(prog(None, second)[1], torch.ones(3))
    storage = second["a"].untyped_storage()

    def over():
        return torch.empty(0).set_(storage, 0, (3,), (1,))
    over().fill_(7.0)                  # through another tensor
    reused = over()
    assert reused.data_ptr() == second["a"].data_ptr()
    assert reused._version == second["a"]._version
    assert torch.equal(prog(None, {"a": reused})[1], torch.full((3,), 7.0))
    assert prog.trace_count == 1
