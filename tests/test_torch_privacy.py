"""The port's §4 private hash (``repro_torch.core.privacy``) against the
JAX package's (``repro.core.privacy``) on the CPU.

The reference's noise is a ``jax.random.normal`` draw that torch cannot
reproduce, so the parity tests draw it with JAX and hand the same
standard-normal ``z`` to the port's ``noisy_srp_bits``, as W is carried
across by ``core.convert``.

Tolerances: ``gaussian_sigma`` exact (the same float64 formula); bits and
bucket ids agree >= 0.999 (the dense-hash floor: the two projections sum
in another float32 order, so a bit at |proj + σz| ~ 0 may flip); at σ = 0
the port's private ids are bitwise its own plain ``hash_buckets``;
``expected_bit_flip_rate`` within rtol 1e-6 wherever the rate is at
least 1e-8 (margins within 5.6σ; ``erfc`` of two libraries), and in the
far tail beyond within rtol 5e-6 (the two ``erfc``s drift apart by up to
4e-6 there) and atol 1.2e-38 (XLA's CPU flushes the subnormal rates past
9.2σ to 0).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")   # the optional `torch` extra

from repro.core import privacy as jpriv  # noqa: E402
from repro.core import srp as jsrp  # noqa: E402
from repro_torch.core import privacy as priv  # noqa: E402
from repro_torch.core import srp  # noqa: E402
from repro_torch.core.convert import params_from_numpy  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

CPU = torch.device("cpu")
FLOOR = 0.999


def _setup(n=400, d=32, K=8, L=16, seed=0):
    jcfg = jsrp.SrpConfig(dim=d, num_bits=K, num_tables=L, seed=seed)
    cfg = srp.SrpConfig(dim=d, num_bits=K, num_tables=L, seed=seed)
    w = np.asarray(jsrp.make_projections(jcfg))
    x = np.random.default_rng(seed + 1).normal(size=(n, d)).astype(
        np.float32)
    return jcfg, cfg, w, x


@pytest.mark.parametrize("eps,delta,sens", [
    (1.0, 1e-5, 1.0), (0.5, 1e-6, 16.3), (8.0, 0.5, 0.01), (1e-3, 1e-9, 2.0)])
def test_gaussian_sigma_exact(eps, delta, sens):
    assert priv.gaussian_sigma(eps, delta, sens) \
        == jpriv.gaussian_sigma(eps, delta, sens)


@pytest.mark.parametrize("eps,delta", [(0.0, 1e-5), (-1.0, 1e-5),
                                       (1.0, 0.0), (1.0, 1.0)])
def test_gaussian_sigma_rejects_what_the_reference_rejects(eps, delta):
    with pytest.raises(ValueError):
        jpriv.gaussian_sigma(eps, delta, 1.0)
    with pytest.raises(ValueError):
        priv.gaussian_sigma(eps, delta, 1.0)


@pytest.mark.parametrize("sigma", [0.0, 0.01, 1e3])
def test_bits_and_ids_with_the_reference_noise(sigma):
    jcfg, cfg, w, x = _setup()
    key = jax.random.PRNGKey(7)
    # the reference's own draw: its projection's shape (n, P) and dtype
    z = np.asarray(jax.random.normal(key, (x.shape[0], w.shape[1]),
                                     jnp.float32))
    want_bits = np.asarray(jpriv.private_srp_bits(jnp.asarray(x),
                                                  jnp.asarray(w), jcfg, key,
                                                  sigma))
    want_ids = np.asarray(jpriv.private_hash_buckets(jnp.asarray(x),
                                                     jnp.asarray(w), jcfg,
                                                     key, sigma))
    bits = priv.noisy_srp_bits(torch.as_tensor(x), params_from_numpy(w, CPU),
                               cfg, torch.from_numpy(z.copy()), sigma)
    ids = srp.pack_buckets(bits, cfg)
    assert bits.dtype == torch.int32 and bits.shape == want_bits.shape
    assert ids.shape == want_ids.shape == (400, 16)
    assert float((bits.numpy() == want_bits).mean()) >= FLOOR
    assert float((ids.numpy() == want_ids).mean()) >= FLOOR


def test_sigma_zero_is_the_plain_hash_bitwise():
    _, cfg, w, x = _setup()
    xt, wt = torch.as_tensor(x), params_from_numpy(w, CPU)
    gen = torch.Generator().manual_seed(3)
    ids = priv.private_hash_buckets(xt, wt, cfg, gen, 0.0)
    assert torch.equal(ids, srp.hash_buckets(xt, wt, cfg))


def test_generator_draw_deterministic_and_shaped():
    _, cfg, w, x = _setup()
    xt, wt = torch.as_tensor(x), params_from_numpy(w, CPU)
    sig = priv.gaussian_sigma(1.0, 1e-5, 1.0)
    a = priv.private_hash_buckets(xt, wt, cfg,
                                  torch.Generator().manual_seed(0), sig)
    b = priv.private_hash_buckets(xt, wt, cfg,
                                  torch.Generator().manual_seed(0), sig)
    c = priv.private_hash_buckets(xt, wt, cfg,
                                  torch.Generator().manual_seed(1), sig)
    assert a.shape == (400, 16) and a.dtype == torch.int32
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert int(a.min()) >= 0 and int(a.max()) < cfg.num_buckets


def test_utility_degrades_gracefully():
    """The reference's contract: small noise leaves most bits, huge noise
    flips about half."""
    _, cfg, w, x = _setup(n=100, d=32, K=8, L=16)
    xt, wt = torch.as_tensor(x), params_from_numpy(w, CPU)
    plain = srp.srp_bits(xt, wt, cfg)
    gen = torch.Generator().manual_seed(1)
    lo = priv.private_srp_bits(xt, wt, cfg, gen, 0.01)
    hi = priv.private_srp_bits(xt, wt, cfg, gen, 1e3)
    assert float((plain == lo).float().mean()) > 0.95
    assert 0.4 < float((plain == hi).float().mean()) < 0.6


@pytest.mark.parametrize("sigma", [0.0, 1e-3, 0.5, 3.0, 77.0])
def test_expected_bit_flip_rate(sigma):
    margin = np.random.default_rng(4).normal(size=(64, 48)).astype(
        np.float32) * 2.0
    margin[0, :3] = (0.0, -0.0, 1e-30)
    want = np.asarray(jpriv.expected_bit_flip_rate(jnp.asarray(margin),
                                                   sigma))
    got = priv.expected_bit_flip_rate(torch.as_tensor(margin), sigma)
    assert got.dtype == torch.float32 and got.shape == margin.shape
    bulk = want >= 1e-8
    np.testing.assert_allclose(got.numpy()[bulk], want[bulk], rtol=1e-6)
    np.testing.assert_allclose(got.numpy()[~bulk], want[~bulk], rtol=5e-6,
                               atol=1.2e-38)
    if sigma == 0.0:
        assert not got.any()
    else:
        assert float(got[0, 0]) == 0.5


def test_measured_flip_rate_matches_expected():
    """The noise is N(0, σ²): the share of flipped bits lies within 3
    standard errors of the mean expected rate (what the card checks at
    the KDD size)."""
    _, cfg, w, x = _setup(n=2000, d=16, K=8, L=16)
    xt, wt = torch.as_tensor(x), params_from_numpy(w, CPU)
    xt = xt / torch.linalg.vector_norm(xt, dim=1, keepdim=True)
    sigma = 0.8
    margin = priv.projections(xt, wt)[:, : cfg.num_projections]
    flips = priv.private_srp_bits(xt, wt, cfg,
                                  torch.Generator().manual_seed(5), sigma) \
        != srp.srp_bits(xt, wt, cfg)
    p = priv.expected_bit_flip_rate(margin, sigma).double()
    se = math.sqrt(float((p * (1 - p)).sum())) / p.numel()
    assert abs(float(flips.double().mean()) - float(p.mean())) <= 3 * se
