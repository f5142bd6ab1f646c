"""The one-launch findHH drill-down (``kernels/attr_estimate.py``
``attr_find_hh``, ``ops.attr_find_hh``, ``attribution.find_hh``) on CPU
tensors, where the wrapper takes ``attr_find_hh_plain``, against the
reference's ``repro.attribution.find_hh`` on the reference's own plane and
hash tables (carried across with ``convert.attr_tables_from_numpy``); the
kernel's slot rule against the ranking of the plain version; the
wrapper's operand checks and its shape-chosen data layout.

Tolerances: coordinates, estimates and valid flags equal on every lane
(estimates by value: a median of empty cells may be +0.0 or -0.0); the
slot rule exact.  The CUDA kernel itself runs only on a card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``), bitwise this plain
version.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")   # the optional `torch` extra

from repro import attribution as jat  # noqa: E402
from repro.attribution import sketch as jatsk  # noqa: E402
from repro_torch.attribution import sketch as at  # noqa: E402
from repro_torch.core import convert  # noqa: E402
from repro_torch.kernels import attr_estimate as AE  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

CPU = torch.device("cpu")


@functools.lru_cache(maxsize=None)
def _case(dim, rows):
    """(JAX config, port config, port tables carrying JAX's, the JAX plane,
    the plane as a tensor): the reference's sketch of a vector with three
    heavy coordinates of both signs (bits 8 at d = 4097, else 6)."""
    bits = 8 if dim > 64 else 6
    jc = jat.AttrConfig(dim=dim, rows=rows, bits=bits, seed=5)
    pc = at.AttrConfig(dim=dim, rows=rows, bits=bits, seed=5)
    cols, signs = jatsk._level_tables_np(jc)
    tables = convert.attr_tables_from_numpy(cols, signs, pc, CPU)
    rng = np.random.default_rng(dim * 10 + rows)
    v = rng.normal(size=(dim,)).astype(np.float32) * 0.1
    heavy = rng.choice(dim, size=min(3, dim), replace=False)
    v[heavy] = np.array([9.0, -7.0, 5.0], np.float32)[: heavy.size]
    plane = jat.sketch_vector(jc, jnp.asarray(v))
    return jc, pc, tables, plane, torch.from_numpy(np.array(plane))


@pytest.mark.parametrize("rows", [1, 4, 5])
@pytest.mark.parametrize("topk", [1, 3, 8, 17, 18])
@pytest.mark.parametrize("dim", [2, 13, 37, 48, 4097])
def test_find_hh_matches_reference(dim, topk, rows):
    """Both paths of ``attribution.find_hh`` and the wrapper itself equal
    the reference on every lane: a one-level tree (d = 2), powers of two
    and not, topk past the valid coordinates, 2W > 32 children (topk 17
    and 18, the kernel's shared-memory ranking)."""
    jc, pc, tables, plane, pp = _case(dim, rows)
    want = [np.asarray(x) for x in jat.find_hh(jc, plane, topk)]
    got = [at.find_hh(pc, tables, pp, topk, use_kernels)
           for use_kernels in (True, False)]
    got.append(ops.attr_find_hh(pp, tables.cols, tables.signs, dim, topk))
    for g in got:
        for a, w in zip(g, want):
            assert a.numpy().dtype == w.dtype and a.shape == w.shape
            np.testing.assert_array_equal(a.numpy(), w)


def test_find_hh_is_the_per_level_composition():
    """The plain drill-down with the batch estimate wrapper at each level
    (the composition the stream ran before the one-launch kernel) gives
    the same lanes."""
    _, pc, tables, _, pp = _case(4097, 5)
    args = (pp, tables.cols, tables.signs, 4097, 8)
    want = AE.attr_find_hh_plain(*args)
    got = AE.attr_find_hh_plain(*args, estimator=ops.attr_estimate)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _rank_keys(rank: np.ndarray) -> np.ndarray:
    """The kernel's ``rank_key``: -inf 0, a number >= 0 its float32 bits
    + 1, NaN 0xffffffff (uint32)."""
    bits = rank.astype(np.float32).view(np.uint32).astype(np.uint64) + 1
    keys = np.where(np.isnan(rank), 0xFFFFFFFF, np.where(rank < 0, 0, bits))
    return keys.astype(np.uint64)


def _slots(rank: np.ndarray) -> np.ndarray:
    """The kernel's slot rule on its integer keys: child i goes to
    p_i = #{j: key_j > key_i} + #{j < i: key_j == key_i}."""
    keys = _rank_keys(rank)
    return np.array([(keys > k).sum() + (keys[:i] == k).sum()
                     for i, k in enumerate(keys)], np.int64)


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1), n=st.integers(1, 80),
       levels=st.integers(1, 6))
def test_slot_rule_is_the_stable_descending_sort(seed, n, levels):
    """The slots form a permutation, and the item in slot p is the p-th of
    ``top_indices`` (``torch.sort(descending=True, stable=True)``) on
    ranks as the drill-down makes them (|estimate|, +inf included, -inf
    for masked children, NaN), with many ties."""
    rng = np.random.default_rng(seed)
    values = np.array([-np.inf, np.nan, 0.0, 1.5, 2.0, 7.0, np.inf],
                      np.float32)
    rank = rng.choice(values[: levels + 1], size=n).astype(np.float32)
    rank[rng.random(n) < 0.3] = rng.random() * 3
    p = _slots(rank)
    assert sorted(p.tolist()) == list(range(n))
    order = np.empty(n, np.int64)
    order[p] = np.arange(n)
    want = AE.top_indices(torch.from_numpy(rank), n).numpy()
    np.testing.assert_array_equal(order, want)


def test_nan_ranks_first_and_ties_go_to_the_lower_index():
    rank = torch.tensor([1.0, float("nan"), -float("inf"), 3.0,
                         float("nan"), 3.0, -float("inf")])
    assert AE.top_indices(rank, 7).tolist() == [1, 4, 3, 5, 0, 2, 6]
    np.testing.assert_array_equal(_slots(rank.numpy()),
                                  [4, 0, 5, 2, 1, 3, 6])


def test_wrapper_checks_its_operands():
    cfg = at.AttrConfig(dim=13, rows=3, bits=4)
    t = at.level_tables(cfg, CPU)
    plane = torch.zeros((4, 3, 16))
    assert [x.shape for x in AE.attr_find_hh(plane, t.cols, t.signs, 13,
                                             5)] == [(5,)] * 3
    with pytest.raises(ValueError, match="topk"):
        AE.attr_find_hh(plane, t.cols, t.signs, 13, 0)
    with pytest.raises(ValueError, match="dim"):
        AE.attr_find_hh(plane, t.cols, t.signs, 17, 5)      # 5 levels
    with pytest.raises(ValueError, match="dim"):
        AE.attr_find_hh(plane, t.cols, t.signs, 8, 5)       # 3 levels
    with pytest.raises(TypeError):
        AE.attr_find_hh(plane, t.cols.long(), t.signs, 13, 5)
    with pytest.raises(TypeError):
        AE.attr_find_hh(plane.double(), t.cols, t.signs, 13, 5)
    with pytest.raises(ValueError):
        AE.attr_find_hh(plane, t.cols[:, :8].contiguous(), t.signs, 13, 5)
    with pytest.raises(ValueError):
        AE.attr_find_hh(plane[:, :2].contiguous(), t.cols, t.signs, 13, 5)
    with pytest.raises(ValueError, match="contiguous"):
        AE.attr_find_hh(plane.transpose(1, 2).contiguous().transpose(1, 2),
                        t.cols, t.signs, 13, 5)
    with pytest.raises(ValueError):
        AE.attr_find_hh(plane.to("meta"), t.cols, t.signs, 13, 5)
    before = AE.KERNEL.launches, AE.FIND_HH_KERNEL.launches
    AE.attr_find_hh(plane, t.cols, t.signs, 13, 5)
    assert (AE.KERNEL.launches, AE.FIND_HH_KERNEL.launches) == before, \
        "the plain version launches nothing"


@pytest.mark.parametrize("NL,R,C,topk,stage,beam_in_smem", [
    (13, 5, 256, 8, True, True),        # the defaults: 66.6 KB staged
    (13, 8, 256, 300, True, True),
    (13, 1, 2048, 8, True, True),       # bits 11 fits at R = 1, 2
    (13, 2, 2048, 300, False, True),    # ... but not beside a wide beam
    (13, 3, 2048, 8, False, True),
    (13, 5, 2048, 8, False, True),
    (20, 5, 1 << 20, 8, False, True),   # bits 20: far past a block
    (13, 5, 256, 3000, True, False),    # the beam alone past 227 KB
    (13, 5, 2048, 3000, False, False),
])
def test_layout_is_chosen_by_shape(NL, R, C, topk, stage, beam_in_smem):
    """Where the kernel keeps the hierarchy and the beam: staged plane and
    beam together within a block's 227 KB, else the plane read from
    global memory, else (topk in the thousands) the beam in a device
    workspace."""
    assert AE.find_hh_layout(NL, R, C, topk) == (stage, beam_in_smem)
    W = AE.beam_width(topk)
    used = AE.BEAM_LANE_BYTES * W * beam_in_smem + 4 * NL * R * C * stage
    assert used <= AE.SMEM_PER_BLOCK


@pytest.mark.parametrize("dim,nl", [(1, 1), (2, 1), (3, 2), (4, 2), (5, 3),
                                    (4096, 12), (4097, 13)])
def test_num_levels_matches_the_config(dim, nl):
    assert AE.num_levels(dim) == nl == at.AttrConfig(dim=dim).num_levels
