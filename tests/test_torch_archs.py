"""The port's model zoo (``repro_torch.configs``, ``repro_torch.models``)
against the reference's, config by config, at the reduced sizes in
float32 on the CPU, both on one set of weights: the port's own init,
stacked into the reference's layout (``reference_tree``) and carried back
by ``params_from_reference`` (the reference's jitted init costs 1.5-3 s of
XLA compile a config; its own init is carried across in
``test_own_init_matches_reference_distribution``).

Tolerances: logits, aux values and decode logits within rtol 2e-4 / atol
2e-4, the reference's own bound for prefill + decode against forward
(``tests/test_archs.py:122``); config fields, parameter counts and greedy
tokens exact.  The port's own init matches the reference's distribution
in every family: each random leaf's standard deviation within 5%, pooled
over the superblocks (whisper: the layers) of a config wide and deep
enough that every leaf holds >= 16,384 values; constant leaves exactly,
Mamba's ``A_log`` = log(1..N) within 1 ulp.  The Mamba, RWKV and whisper
models are held to the reference's forward, decode and engine in
``test_torch_mamba``, ``test_torch_rwkv`` and ``test_torch_whisper``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")   # the optional `torch` extra

from repro import configs as jconfigs  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.registry import Arch as JArch  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.registry import Arch, leaves  # noqa: E402
from torch_zoo_helpers import reference_tree  # noqa: E402

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
FAMILY = ["mistral_large_123b", "gemma2_27b", "olmo_1b", "qwen2_1_5b",
          "qwen2_vl_7b", "mixtral_8x7b", "mixtral_8x22b"]
TOL = dict(rtol=2e-4, atol=2e-4)


def reference_params(ja: JArch, seed: int = 1):
    """The reference's init (jitted: its eager init is seconds a config) as
    a tree of numpy arrays."""
    p = jax.jit(lambda k: ja.init_params(k)[0])(jax.random.PRNGKey(seed))
    return jax.tree.map(np.asarray, p)


@functools.lru_cache(maxsize=None)
def pair(name: str, seed: int = 1):
    """(reference Arch, its params, port Arch, the port's params carried
    there and back), made once a file."""
    ja, a = JArch(name, reduced=True), Arch(name, reduced=True)
    tree = reference_tree(a.init_params(seed, device="cpu"), a.cfg)
    return ja, tree, a, params_from_reference(a.cfg, tree, CPU)


def _batch(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "tokens":
        return {"tokens": rng.integers(0, cfg.vocab_size, (B, S))
                .astype(np.int32)}
    return {"embeds": rng.normal(size=(B, S, cfg.d_model)).astype(np.float32),
            "positions": np.tile(np.arange(S, dtype=np.int32), (3, B, 1))}


def _slice(batch, lo, hi):
    return {k: (v[:, :, lo:hi] if k == "positions" else v[:, lo:hi])
            for k, v in batch.items()}


def _t(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize("name", configs.ARCHS)
def test_config_fields_equal_reference(name):
    assert configs.ARCHS == jconfigs.ARCHS
    assert configs.ALIASES == jconfigs.ALIASES
    for reduced in (False, True):
        got = configs.get_config(name, reduced=reduced)
        want = jconfigs.get_config(name, reduced=reduced)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.num_superblocks == want.num_superblocks
        assert got.adtype == getattr(torch, str(want.adtype))
        assert got.pdtype == getattr(torch, str(want.pdtype))


@pytest.mark.parametrize("name", configs.ARCHS)
def test_param_counts_equal_reference(name):
    a, ja = Arch(name), JArch(name)
    assert all(t.device.type == "meta" for t in leaves(a._shapes()))
    assert a.param_count() == ja.param_count()
    assert a.active_param_count() == ja.active_param_count()


@pytest.mark.parametrize("name", FAMILY)
def test_forward_prefill_decode_match_reference(name):
    """forward's logits and aux against the reference's forward; then
    prefill of 8 positions and 4 decode steps, teacher-forced on the
    batch's own inputs, each position's logits against the reference's
    forward logits there (its own serving property, held across the two
    packages; the reference's decode itself is held in
    ``test_ring_cache_equals_full`` and through ``ServeEngine.generate``
    in ``test_torch_serve_engine``)."""
    ja, jp, a, p = pair(name)
    cfg = a.cfg
    B, S, P = 2, 12, 8
    batch = _batch(cfg, B, S, seed=1)
    logits, aux = a.forward(p, _t(batch))
    jlogits, jaux = jax.jit(lambda q, b: ja.forward(q, b, remat=False))(
        jp, _j(batch))
    jlogits = np.asarray(jlogits)
    np.testing.assert_allclose(logits.numpy(), jlogits, **TOL)
    assert set(aux) == set(jaux)
    for k in aux:
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), **TOL)

    last, cache = a.prefill(p, _t(_slice(batch, 0, P)), s_max=S)
    np.testing.assert_allclose(last[:, 0].numpy(), jlogits[:, P - 1], **TOL)
    assert cache[0][0].k.shape == (B, S, cfg.num_kv_heads, cfg.head_dim)
    for t in range(P, S):
        step = _slice(batch, t, t + 1)
        step.pop("positions", None)
        pos = np.full((B,), t, np.int32)
        if cfg.mrope_sections is not None:
            pos = np.broadcast_to(pos, (3, B)).copy()
        got, cache = a.decode_step(p, _t(step), cache, torch.as_tensor(pos))
        np.testing.assert_allclose(got[:, 0].numpy(), jlogits[:, t], **TOL)


def test_ring_cache_equals_full():
    """A window-sized ring cache decodes as the full cache does (mixtral,
    every layer "swa", window 16) over 24 steps that wrap it, and as the
    reference's ring does."""
    ja, jp, a, p = pair("mixtral_8x7b")
    cfg = a.cfg
    B, T = 2, 24
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, T))

    def decode_all(step, init, s_max, asarray):
        cache = init(s_max)
        outs = []
        for t in range(T):
            logits, cache = step(
                {"tokens": asarray(toks[:, t:t + 1].astype(np.int32))},
                cache, asarray(np.full((B,), t, np.int32)))
            outs.append(np.asarray(logits[:, 0]))
        return np.stack(outs)

    def port(s_max):
        return decode_all(lambda b, c, q: a.decode_step(p, b, c, q),
                          lambda s: tf.init_cache(cfg, B, s, CPU), s_max,
                          torch.as_tensor)

    full, ring = port(T), port(cfg.sliding_window)
    np.testing.assert_allclose(ring, full, **TOL)
    np.testing.assert_array_equal(ring.argmax(-1), full.argmax(-1))
    jstep = jax.jit(ja.decode_step)
    jring = decode_all(lambda b, c, q: jstep(jp, b, c, q),
                       lambda s: jtf.init_cache(ja.cfg, B, s),
                       cfg.sliding_window, jnp.asarray)
    np.testing.assert_allclose(ring, jring, **TOL)


def _stacks(port_params, ref_tree):
    """(path prefix, the reference's stacked subtree, the port's layers)
    of every stack: each pattern position over the superblocks, whisper's
    encoder and decoder over their layers."""
    for i, stacked in enumerate(ref_tree.get("blocks", [])):
        yield (f"blocks.{i}", stacked,
               [row[i] for row in port_params["blocks"]])
    for k in ("enc", "dec"):
        if k in ref_tree:
            yield k, ref_tree[k], port_params[k]


def _pooled_stats(port_params, ref_tree):
    """{leaf path: (port values, reference values)}, each pooled over the
    layers of its stack."""
    out = {}
    for prefix, stacked, layers in _stacks(port_params, ref_tree):
        for path, ref in _flat(stacked):
            got = [_get(layer, path) for layer in layers]
            out[f"{prefix}.{path}"] = (torch.stack(got).numpy(), ref)
    for k, v in ref_tree.items():
        if k not in ("blocks", "enc", "dec"):
            for path, ref in _flat({k: v}):
                out[path] = (_get(port_params, path).numpy(), ref)
    return out


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def _flat_t(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_t(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _get(tree, path):
    for k in path.split("."):
        tree = tree[k]
    return tree


@pytest.mark.parametrize("name,widen", [
    ("mixtral_8x7b", dict(d_model=512, num_heads=8, num_kv_heads=2,
                          head_dim=32, d_ff=64, moe_num_experts=8)),
    ("qwen2_1_5b", dict(d_model=256, num_heads=8, num_kv_heads=4,
                        head_dim=64, d_ff=256)),
    # 32 superblocks: conv_w (4, 128), dt_proj_w (4, 128) and the router
    # (64, 8) pool 16,384
    ("jamba_v01_52b", dict(d_model=64, num_layers=256, mamba_d_state=16,
                           d_ff=16, moe_num_experts=8)),
    # 128 layers: bonus_u (8, 16) pools 16,384
    ("rwkv6_7b", dict(num_layers=128, d_ff=128)),
    ("whisper_tiny", dict(d_model=128, num_heads=4, num_kv_heads=4,
                          head_dim=32)),
])
def test_own_init_matches_reference_distribution(name, widen):
    """The port's init draws each leaf from the reference's distribution:
    fan-in from the FIRST axis (experts (E, D, F) std 1/sqrt(E), ``wo``
    (H, Dh, D) 1/sqrt(H), RWKV's ``tm_w2`` (5, 32, D) 1/sqrt(5) and
    ``bonus_u`` (H, Dh) 1/sqrt(H)), Mamba's ``conv_w`` at scale 0.5,
    embeddings 0.02, norms, biases and RWKV's zero leaves constant."""
    a, ja = Arch(name, reduced=True), JArch(name, reduced=True)
    a.cfg = dataclasses.replace(a.cfg, **widen)
    ja.cfg = dataclasses.replace(ja.cfg, **widen)
    ref = reference_params(ja, seed=5)
    port = a.init_params(5, device="cpu")
    carried = params_from_reference(a.cfg, ref, CPU)

    def layer_shapes(params):
        return [[{k: tuple(t.shape) for k, t in _flat_t(x)} for x in layers]
                for _, _, layers in _stacks(params, ref)]

    assert layer_shapes(carried) == layer_shapes(port)
    for _, stacked, layers in _stacks(carried, ref):
        path, leaf = next(_flat(stacked))
        np.testing.assert_array_equal(_get(layers[-1], path), leaf[-1])
    stats = _pooled_stats(port, ref)
    assert len(stats) == len(jax.tree.leaves(ref))
    for path, (got, want) in stats.items():
        assert got.shape == want.shape and got.dtype == want.dtype, path
        if path.endswith(".A_log"):     # log(1..N), torch's log and XLA's
            np.testing.assert_allclose(got, want, rtol=2e-7, atol=0)
            continue
        if want.std() == 0:
            np.testing.assert_array_equal(got, want, err_msg=path)
            continue
        assert want.size >= 16_384, path
        ratio = got.std() / want.std()
        assert abs(ratio - 1) <= 0.05, (path, got.std(), want.std())
        # both truncated at 2 std of the untruncated normal
        ratio = np.abs(got).max() / np.abs(want).max()
        assert abs(ratio - 1) <= 0.05, (path, ratio)
    if a.cfg.moe_num_experts:     # 0.8796: a standard normal cut at ±2
        i = next(i for i in range(len(a.cfg.block_pattern))
                 if tf._layer_has_moe(a.cfg, i))
        np.testing.assert_allclose(
            stats[f"blocks.{i}.mlp.w_gate"][0].std(),
            0.8796 / np.sqrt(a.cfg.moe_num_experts), rtol=0.05)
