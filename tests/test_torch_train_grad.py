"""The port's training loss and backward pass (``Arch.loss``:
``transformer.next_token_loss``, ``whisper.next_token_loss``; PyTorch
autograd, ``forward(remat=, remat_policy=)``, the checkpointed chunk
scans of ``mamba_scan`` and ``rwkv_time_scan``) against ``jax.grad`` of
the reference's loss, on one set of weights (``torch_zoo_helpers.pair``:
the port's init in the reference's layout, RWKV's zero leaves redrawn)
and one numpy batch with a random loss mask, at the reduced configs in
float32 on the CPU: attention (qwen2), MoE (mixtral), Jamba's Mamba
hybrid with MoE, RWKV-6, whisper.

Tolerances: the loss within rtol 2e-4 (the reference's bound for its
own forward paths, ``tests/test_archs.py:122``); each gradient leaf
within 2e-4 of the leaf's largest magnitude (largest seen 1.2e-4, an
RWKV leaf: the WKV recurrence sums 16 steps of products in another
order).  In the port, remat off, ``"full"`` and ``"dots"`` give bitwise
equal losses and gradients (the recomputed forward is the same code on
the same inputs), and the chunked scans equal the in-place inference
loops bitwise in value.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")   # the optional `torch` extra

from repro_torch.models import mamba as mb  # noqa: E402
from repro_torch.models import rwkv6 as rw  # noqa: E402
from repro_torch.models.convert import params_to_reference  # noqa: E402
from repro_torch.models.registry import leaves, unflatten  # noqa: E402
from torch_zoo_helpers import (as_jax, as_torch, batch_for,  # noqa: E402
                               one_torch_thread, pair)

_threads = pytest.fixture(autouse=True, scope="module")(one_torch_thread)
NAMES = ["qwen2_1_5b", "mixtral_8x7b", "jamba_v01_52b", "rwkv6_7b",
         "whisper_tiny"]
TOL = 2e-4


def _batch(cfg):
    b = batch_for(cfg, 2, 16, seed=3)
    rng = np.random.default_rng(4)
    b["labels"] = b["tokens"]
    b["mask"] = (rng.random((2, 16)) > 0.25).astype(np.float32)
    return b


@functools.lru_cache(maxsize=None)
def reference_grads(name):
    ja, jp, a, _ = pair(name)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda q, b: ja.loss(q, b, remat=False)[0]))(jp, as_jax(_batch(a.cfg)))
    return float(loss), [np.asarray(g) for g in jax.tree.leaves(grads)]


def port_grads(name, **kw):
    _, _, a, p = pair(name)
    flat = [t.detach().requires_grad_() for t in leaves(p)]
    loss, aux = a.loss(unflatten(p, flat), as_torch(_batch(a.cfg)), **kw)
    grads = torch.autograd.grad(loss, flat)
    return loss.detach(), aux, unflatten(p, list(grads))


@pytest.mark.parametrize("name", NAMES)
def test_loss_and_grads_against_jax_grad(name):
    want_loss, want = reference_grads(name)
    loss, aux, grads = port_grads(name, remat=True)
    np.testing.assert_allclose(float(loss), want_loss, rtol=TOL)
    assert torch.equal(aux["nll"].detach(), loss)
    got = jax.tree.leaves(params_to_reference(grads))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=TOL * float(np.max(np.abs(w))))


@pytest.mark.parametrize("name", NAMES)
def test_remat_policies_give_equal_gradients(name):
    runs = [port_grads(name, remat=False),
            port_grads(name, remat=True, remat_policy="full"),
            port_grads(name, remat=True, remat_policy="dots")]
    for loss, _, grads in runs[1:]:
        assert torch.equal(loss, runs[0][0])
        for x, y in zip(leaves(grads), leaves(runs[0][2])):
            assert torch.equal(x, y)
    with pytest.raises(ValueError, match="remat_policy"):
        port_grads("qwen2_1_5b", remat_policy="offload")


def test_loss_masks_and_moe_term():
    """The mask's sum divides (a zero mask gives 0, not NaN); MoE adds
    0.01 · moe_load_balance / num_layers; whisper ignores the mask, as
    the reference does (ROADMAP.md queue 3)."""
    _, _, a, p = pair("mixtral_8x7b")
    b = as_torch(_batch(a.cfg))
    with torch.no_grad():
        loss, aux = a.loss(p, dict(b, mask=torch.zeros_like(b["mask"])))
        lb = aux["moe_load_balance"]
        assert float(loss) == pytest.approx(
            0.01 * float(lb) / a.cfg.num_layers, rel=1e-6)
        _, _, w, wp = pair("whisper_tiny")
        wb = as_torch(_batch(w.cfg))
        l1, _ = w.loss(wp, wb)
        l0, _ = w.loss(wp, dict(wb, mask=torch.zeros_like(wb["mask"])))
        assert torch.equal(l1, l0)


def _requires_grad(p):
    return {k: v.detach().requires_grad_() for k, v in p.items()}


@pytest.mark.parametrize("time_chunk", [4, 16])
def test_chunked_scans_equal_the_inplace_loops(time_chunk):
    _, _, a, p = pair("jamba_v01_52b")
    cfg = a.cfg
    i = cfg.block_pattern.index("mamba")
    mp = p["blocks"][0][i]["mixer"]
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(2, 16, cfg.d_model)).astype(np.float32))
    with torch.no_grad():
        want, wst = mb.mamba_scan(mp, x, cfg, time_chunk=time_chunk)
    got, gst = mb.mamba_scan(_requires_grad(mp), x, cfg,
                             time_chunk=time_chunk)
    assert got.requires_grad and torch.equal(got.detach(), want)
    assert torch.equal(gst.ssm.detach(), wst.ssm)

    _, _, r, rp = pair("rwkv6_7b")
    tp = rp["blocks"][0][0]["mixer"]
    xr = torch.from_numpy(np.random.default_rng(6).normal(
        size=(2, 16, r.cfg.d_model)).astype(np.float32))
    st = rw.init_rwkv_state(r.cfg, 2, torch.float32, xr.device)
    with torch.no_grad():
        want = rw.rwkv_time_scan(tp, xr, st.x_prev_att, st.wkv, r.cfg,
                                 time_chunk=time_chunk)
    got = rw.rwkv_time_scan(_requires_grad(tp), xr, st.x_prev_att, st.wkv,
                            r.cfg, time_chunk=time_chunk)
    assert got[0].requires_grad
    for g, w in zip(got, want):
        assert torch.equal(g.detach(), w)
    assert not torch.any(st.wkv)                     # wkv0 left alone
    with pytest.raises(AssertionError):
        mb.mamba_scan(_requires_grad(mp), x[:, :15], cfg, time_chunk=4)
