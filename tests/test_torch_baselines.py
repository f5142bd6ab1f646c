"""The port's 11 baselines (``repro_torch.baselines``) against the JAX
package's (``repro.baselines``) on the CPU, at n <= 300.

Tolerances, each with its reason:
- kNN graph: indices equal; distances within rtol 1e-5 (both use the
  expansion trick in one order, but the float32 products and row sums
  are summed in another order by XLA and by PyTorch);
- inner pairwise distances within rtol 1e-5 (the (k+1)² sums over d in
  another order), also when the port builds them in chunks;
- every score within rtol 1e-4 / atol 1e-6 on the same graph (float32
  means and sums over k or n in another order; KDEOS's z-score divides
  by a spread that can be small, hence the atol);
- ``run_baseline`` end to end, each package on its own graph, within
  rtol 1e-3 / atol 1e-5: the two graphs' distances differ within rtol
  1e-5, which the density scores amplify (KDEOS by up to 5e-4 here);
- FastVOA with the reference's hyperplanes and signs carried across:
  every hyperplane's rank order equal, its l·r and SL·SR products
  bitwise, and VOA within rtol 1e-6 (the float64 sums are taken in the
  reference's order).  Ranks follow float32 projections that XLA and
  PyTorch sum in different orders, so the data is held to a stated
  precondition: no two points of any hyperplane lie within the float32
  rounding bound of each other.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")   # the optional `torch` extra

from repro.baselines import ALL_BASELINES as J_ALL  # noqa: E402
from repro.baselines import run_baseline as j_run  # noqa: E402
from repro_torch.baselines import (ALL_BASELINES, GRAPH_BASED,  # noqa: E402
                                   NEIGHBORHOOD_BASED, run_baseline)

jax.config.update("jax_platform_name", "cpu")

CPU = torch.device("cpu")
# the submodules (each package's __init__ rebinds the names of the
# functions it re-exports, so import the modules by path)
jk, jnb, jcof, jfv = (importlib.import_module(f"repro.baselines.{m}")
                      for m in ("knn_graph", "neighbors", "cof", "fastvoa"))
tk, tnb, tcof, tfv = (importlib.import_module(f"repro_torch.baselines.{m}")
                      for m in ("knn_graph", "neighbors", "cof", "fastvoa"))

SCORE_RTOL, SCORE_ATOL = 1e-4, 1e-6


def _data(n=300, d=8, n_out=10, seed=3):
    """An inlier blob plus scattered far outliers (the reference test's
    ``_clustered_with_outliers``)."""
    rng = np.random.default_rng(seed)
    mu = 4.0 * np.ones(d) / np.sqrt(d)
    inl = rng.normal(size=(n - n_out, d)) + mu
    dirs = rng.normal(size=(n_out, d))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    out = mu + dirs * rng.uniform(12.0, 20.0, size=(n_out, 1))
    x = np.vstack([inl, out]).astype(np.float32)
    y = np.concatenate([np.zeros(n - n_out), np.ones(n_out)]).astype(np.int8)
    return x, y


@pytest.fixture(scope="module")
def graphs():
    """The reference's graph and inner distances on ``_data()``, and the
    same carried to the port as CPU tensors."""
    x, _ = _data()
    d, i = jk.knn_graph(x, 5)
    inner = np.array(jk.pairwise_within_neighborhood(x, i))
    return x, (d, i, inner), (torch.as_tensor(d), torch.as_tensor(i).long(),
                              torch.as_tensor(inner))


class TestKnnGraph:
    @pytest.mark.parametrize("k,chunk", [(5, 2048), (5, 37), (7, 150),
                                         (10, 64)])
    def test_matches_reference(self, k, chunk):
        x, _ = _data()
        jd, ji = jk.knn_graph(x, k, chunk=chunk)
        td, ti = tk.knn_graph(x, k, chunk=chunk, device="cpu")
        assert td.dtype == torch.float32 and td.shape == (300, k)
        np.testing.assert_array_equal(ti.numpy(), ji)
        np.testing.assert_allclose(td.numpy(), jd, rtol=1e-5)

    def test_chunking_invariance(self):
        x, _ = _data(n=150)
        d1, i1 = tk.knn_graph(x, 7, chunk=150, device="cpu")
        d2, i2 = tk.knn_graph(x, 7, chunk=31, device="cpu")
        assert torch.equal(i1, i2) and torch.equal(d1, d2)

    @pytest.mark.parametrize("chunk", [65_536, 1, 37, 299])
    def test_inner_pairwise(self, chunk):
        x, _ = _data()
        _, ji = jk.knn_graph(x, 5)
        want = np.asarray(jk.pairwise_within_neighborhood(x, ji))
        got = tk.pairwise_within_neighborhood(
            x, torch.as_tensor(ji), chunk=chunk)
        assert got.shape == (300, 6, 6)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
        np.testing.assert_array_equal(
            torch.diagonal(got, dim1=1, dim2=2).numpy(), 0.0)


SCORERS = ["lof", "knn", "knnw", "loop", "odin", "kdeos", "ldf", "inflo"]


@pytest.mark.parametrize("name", SCORERS)
def test_graph_scorer_matches_reference(graphs, name):
    _, (d, i, _), tg = graphs
    want = np.asarray(getattr(jnb, f"{name}_score")(d, i))
    got = getattr(tnb, f"{name}_score")(*tg[:2])
    assert got.dtype == torch.float32 and got.shape == (300,)
    np.testing.assert_allclose(got.numpy(), want, rtol=SCORE_RTOL,
                               atol=SCORE_ATOL)


def test_ldof_matches_reference(graphs):
    _, (d, i, inner), tg = graphs
    np.testing.assert_allclose(tnb.ldof_score(*tg).numpy(),
                               np.asarray(jnb.ldof_score(d, i, inner)),
                               rtol=SCORE_RTOL, atol=SCORE_ATOL)


def test_cof_matches_reference(graphs):
    x, (_, i, inner), tg = graphs
    np.testing.assert_allclose(tcof.cof_score(x, tg[1], tg[2]).numpy(),
                               np.asarray(jcof.cof_score(x, i, inner)),
                               rtol=SCORE_RTOL, atol=SCORE_ATOL)


def test_cof_prim_ties_take_the_first_index():
    """Prim's argmin takes the first index on ties, as jnp.argmin: a
    neighbourhood whose distances to the root all tie."""
    pd = np.ones((1, 4, 4), np.float32)
    pd[0, np.arange(4), np.arange(4)] = 0.0
    pd[0, 1, 2] = pd[0, 2, 1] = 0.5
    want = np.asarray(jax.vmap(jcof._ac_dist_single)(jnp.asarray(pd)))
    np.testing.assert_array_equal(tcof.ac_dist(torch.as_tensor(pd)).numpy(),
                                  want)


def test_odin_indegrees_sum_to_nk(graphs):
    _, _, tg = graphs
    s = tnb.odin_score(*tg[:2])
    assert float(s.sum()) == 300 * 5


def test_kdeos_uses_population_std():
    """KDEOS's neighbour spread is jnp.std's population std, not
    torch.std's default sample std: with k = 2 the two differ by √2."""
    d = np.array([[1.0, 2.0], [1.0, 3.0], [2.0, 3.0]], np.float32)
    i = np.array([[1, 2], [0, 2], [0, 1]], np.int32)
    np.testing.assert_allclose(
        tnb.kdeos_score(torch.as_tensor(d), torch.as_tensor(i)).numpy(),
        np.asarray(jnb.kdeos_score(d, i)), rtol=SCORE_RTOL, atol=SCORE_ATOL)


@pytest.mark.parametrize("name", [b for b in ALL_BASELINES
                                  if b != "fastvoa"])
def test_run_baseline_matches_reference(name):
    """End to end: each package builds its own graph (indices equal) and
    scores it; numpy out, seconds > 0."""
    x, y = _data()
    want, _, _, _ = j_run(name, x, k=5)
    got, sec, graph, inner = run_baseline(name, x, k=5, device="cpu")
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    assert sec > 0 and isinstance(graph[0], torch.Tensor)
    assert (inner is not None) == (name in NEIGHBORHOOD_BASED)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5)
    order = np.argsort(got)                   # ascending = most anomalous
    hits = int(np.isin(np.where(y == 1)[0], order[:60]).sum())
    assert hits >= 6, f"{name}: only {hits}/10 outliers in the tail"


def test_run_baseline_shares_graph_and_inner():
    x, _ = _data()
    _, _, graph, _ = run_baseline("lof", x, k=5, device="cpu")
    _, _, g2, inner = run_baseline("ldof", x, k=5, graph=graph,
                                   device="cpu")
    assert g2 is graph
    s, _, _, inner2 = run_baseline("cof", x, k=5, graph=graph, inner=inner,
                                   device="cpu")
    assert inner2 is inner and np.isfinite(s).all()


def test_names_match_reference():
    assert ALL_BASELINES == J_ALL and len(ALL_BASELINES) == 11
    assert set(GRAPH_BASED) | NEIGHBORHOOD_BASED | {"fastvoa"} \
        == set(ALL_BASELINES)
    with pytest.raises(KeyError):
        run_baseline("nope", _data()[0], k=5, device="cpu")


# -- FastVOA -------------------------------------------------------------------

def _reference_draws(n, d, t, s2=2, seed=0):
    """The reference's hyperplanes (t, d) and signs (s2, n), drawn as
    ``repro.baselines.fastvoa.fastvoa_score`` draws them."""
    key0, key_s = jax.random.split(jax.random.PRNGKey(seed))
    keys = jax.random.split(key0, t)
    w = np.stack([np.asarray(jax.random.normal(keys[i], (d,), jnp.float32))
                  for i in range(t)])
    signs = np.array(jax.random.bernoulli(key_s, 0.5, (s2, n))
                     .astype(jnp.float32) * 2.0 - 1.0)
    return keys, w, signs


def _no_near_tie(x, w) -> bool:
    """True when, on every hyperplane, every two points' projections lie
    further apart than two float32 sums of the d products can differ
    (2·d·2^-24·Σ|x_j w_j|, the recursive-summation bound, taken twice),
    so no summation order can swap them (float64 here)."""
    d = x.shape[1]
    z = np.sort(x.astype(np.float64) @ w.T.astype(np.float64), axis=0)
    bound = 2 * d * 2.0**-24 * (np.abs(x).astype(np.float64)
                                @ np.abs(w.T).astype(np.float64)).max(0)
    return bool((np.diff(z, axis=0).min(0) > bound).all())


@pytest.mark.parametrize("n,d,t,seed", [(64, 4, 48, 1), (96, 8, 32, 5)])
def test_fastvoa_matches_reference_with_carried_draws(n, d, t, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, d)) * rng.uniform(0.5, 3.0, (n, 1))
         ).astype(np.float32)
    keys, w, signs = _reference_draws(n, d, t)
    # precondition: the rank order cannot depend on the summation order
    assert _no_near_tie(x, w)
    f1, p, rank = tfv.projection_stats(torch.as_tensor(x),
                                       torch.as_tensor(w),
                                       torch.as_tensor(signs))
    xj, sj = jnp.asarray(x), jnp.asarray(signs)
    for i in range(t):
        f1_j, p_j = jfv._one_projection(xj, keys[i], sj)
        z = np.asarray(xj @ jax.random.normal(keys[i], (d,), jnp.float32))
        np.testing.assert_array_equal(rank[:, i].numpy(),
                                      np.argsort(np.argsort(z, kind="stable"),
                                                 kind="stable"))
        np.testing.assert_array_equal(f1[:, i].numpy(), np.asarray(f1_j))
        np.testing.assert_array_equal(p[:, :, i].numpy(), np.asarray(p_j))
    want = np.asarray(jfv.fastvoa_score(x, t=t))
    got = tfv.fastvoa_score(x, t=t, hyperplanes=w, signs=signs, block=7,
                            device="cpu")
    assert got.dtype == torch.float32 and got.shape == (n,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_fastvoa_seeded_draws():
    """Without carried draws: a seeded torch draw, the same for the same
    seed, another for another; finite scores of the right shape."""
    x, _ = _data(n=120)
    a = tfv.fastvoa_score(x, t=40, seed=3, device="cpu")
    b = tfv.fastvoa_score(x, t=40, seed=3, device="cpu")
    c = tfv.fastvoa_score(x, t=40, seed=4, device="cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.shape == (120,) and bool(torch.isfinite(a).all())
    w, s = tfv.draws(120, 8, 40, 2, 3, CPU)
    assert set(np.unique(s.numpy())) == {-1.0, 1.0}
    assert torch.equal(tfv.fastvoa_score(x, t=40, hyperplanes=w, signs=s,
                                         device="cpu"), a)


def test_fastvoa_runs_at_paper_params():
    x, _ = _data(n=200)
    s, sec, _, _ = run_baseline("fastvoa", x, k=5, fastvoa_t=320,
                                device="cpu")
    assert s.shape == (200,) and np.isfinite(s).all() and sec > 0


@pytest.mark.parametrize("call", [
    lambda x: tk.knn_graph(x, 3), lambda x: tfv.fastvoa_score(x, t=4),
    lambda x: run_baseline("lof", x, 3),
    lambda x: run_baseline("fastvoa", x, 3)], ids=["knn_graph", "fastvoa",
                                                   "run_lof",
                                                   "run_fastvoa"])
def test_entry_points_without_cuda_raise(monkeypatch, call):
    """The entry points run on the card unless given device="cpu", and
    raise without one instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call(_data(n=20)[0])
