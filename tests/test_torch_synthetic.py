"""The port's copy of the paper's datasets (``repro_torch.data.synthetic``)
against the JAX package's (``repro.data.synthetic``): numpy on both sides,
so every output is held bitwise (values, dtypes, shapes)."""
import numpy as np
import pytest

from repro.data import synthetic as ref
from repro_torch.data import synthetic as port

NAMES = sorted(ref.PAPER_STATS)


def _same(a, b):
    assert type(a) is type(b)
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            _same(u, v)
    else:
        assert a == b


def test_paper_stats_equal():
    assert port.PAPER_STATS == ref.PAPER_STATS


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("seed", [0, 11, None])
def test_make_paper_dataset_bitwise(name, seed):
    """n = 2000 with an explicit seed, and with ``seed=None`` (seeded from
    ``hash(name)``: the same within this one process, ROADMAP.md queue 3
    item 8)."""
    a = ref.make_paper_dataset(name, n=2000, seed=seed)
    b = port.make_paper_dataset(name, n=2000, seed=seed)
    assert (b.name, b.n_anomalies, b.n, b.dim, b.bytes()) \
        == (a.name, a.n_anomalies, a.n, a.dim, a.bytes())
    _same(b.x, a.x)
    _same(b.y, a.y)
    assert (b.x >= 0).all() and int(b.y.sum()) == b.n_anomalies


def test_make_paper_dataset_full_size_bitwise():
    a = ref.make_paper_dataset("shuttle", seed=0)
    b = port.make_paper_dataset("shuttle", seed=0)
    assert b.n == ref.PAPER_STATS["shuttle"][0]
    _same(b.x, a.x)
    _same(b.y, a.y)


def test_unknown_dataset_raises():
    with pytest.raises(KeyError):
        port.make_paper_dataset("nope")


@pytest.mark.parametrize("seed", [0, 5])
def test_make_fig1_dataset_bitwise(seed):
    _same(port.make_fig1_dataset(seed), ref.make_fig1_dataset(seed))


@pytest.mark.parametrize("kw", [
    dict(n_steps=12, batch=64, dim=30, shift_step=6),
    dict(n_steps=9, batch=33, dim=10, shift_step=4, anomaly_every=3,
         anomaly_frac=0.5, seed=2),
    dict(n_steps=5, batch=16, dim=12, shift_step=2, anomaly_every=0)])
def test_make_drift_stream_bitwise(kw):
    _same(port.make_drift_stream(**kw), ref.make_drift_stream(**kw))


@pytest.mark.parametrize("shape,dtype,c", [((7, 5), np.float32, 1.0),
                                           ((2, 3, 4), np.float64, 0.25),
                                           ((4,), np.float32, -2.0)])
def test_bias_augment_bitwise(shape, dtype, c):
    x = np.random.default_rng(1).normal(size=shape).astype(dtype)
    _same(port.bias_augment(x, c), ref.bias_augment(x, c))
