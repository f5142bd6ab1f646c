"""``repro_torch.dist.mesh``'s pure helpers, the models' logical-axis rules
and the optimisers' state specs, case for case against the reference, in
this process (no ranks): on the reference test's mesh stubs
(``tests/test_mesh_utils.py``), and for every parameter of the ten
configs at full size (the reference's ``abstract_params``, ``eval_shape``,
no allocation; the port's on ``meta``)."""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import ALIASES
from repro.dist import mesh as jmesh
from repro.models import common as jcommon
from repro.models import transformer as jtf
from repro.models.registry import Arch as JArch
from repro.models.registry import is_whisper, wh_abstract
from repro.train import optim as joptim
from repro_torch.dist import mesh as pmesh
from repro_torch.dist.mesh import P
from repro_torch.models import common as pcommon
from repro_torch.models.registry import Arch
from repro_torch.train import optim as poptim

NAMES = sorted(set(ALIASES.values()))


class _MeshStub:
    """What the helpers read of a mesh: axis names and the device grid's
    shape (the reference test's stub)."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.zeros(shape)


MESHES = {
    "debug": _MeshStub((2, 4), ("data", "model")),
    "production": _MeshStub((16, 16), ("data", "model")),
    "pod": _MeshStub((2, 16, 16), ("pod", "data", "model")),
}
SPECS = [(), (None,), (None, "model"), ("model",), ("data", "model"),
         (None, "model", None), (("data", "model"),), (("pod", "data"),),
         ("model", None, "data")]
SHAPES = [(8,), (7,), (3, 8), (64, 8), (2, 6, 16), (48, 32, 4), (6,),
          (16, 16, 16), (1, 1)]


def _t(ps):
    return tuple(ps)


@pytest.mark.parametrize("mesh", MESHES, ids=str)
def test_sanitize_and_fsdp_match_reference(mesh):
    """``sanitize_pspec`` and ``apply_fsdp`` (over data and over pod) for
    every spec × shape of the grid, as the reference's."""
    m = MESHES[mesh]
    for spec in SPECS:
        axes = {a for e in spec for a in pmesh.dim_axes(e)}
        for shape in SHAPES:
            if len(spec) > len(shape) or not axes <= set(m.axis_names):
                continue
            assert _t(pmesh.sanitize_pspec(P(*spec), shape, m)) == _t(
                jmesh.sanitize_pspec(JP(*spec), shape, m)), (spec, shape)
            for axis in ("data", "pod"):
                assert _t(pmesh.apply_fsdp(P(*spec), shape, m, axis)) == _t(
                    jmesh.apply_fsdp(JP(*spec), shape, m, axis)), \
                    (spec, shape, axis)


@pytest.mark.parametrize("mesh", MESHES, ids=str)
def test_rules_for_match_reference(mesh):
    for long_context in (False, True):
        assert pmesh.rules_for(MESHES[mesh], long_context=long_context) \
            == jmesh.rules_for(MESHES[mesh], long_context=long_context)


def test_layout_pspecs_match_reference():
    """The sketch, window and fleet layouts, and their errors."""
    for layout in ("replicated", "table_sharded"):
        for axis in ("model", "tables"):
            assert [_t(p) for p in pmesh.sketch_pspecs(layout, axis)] == \
                [_t(p) for p in jmesh.sketch_pspecs(layout, axis)]
            assert [_t(p) for p in pmesh.window_pspecs(layout, axis)] == \
                [_t(p) for p in jmesh.window_pspecs(layout, axis)]
    for layout in pmesh.FLEET_LAYOUTS:
        assert [_t(p) for p in pmesh.fleet_pspecs(layout, "model", "data")] \
            == [_t(p) for p in jmesh.fleet_pspecs(layout, "model", "data")]
    for fn in (pmesh.sketch_pspecs, pmesh.window_pspecs, pmesh.fleet_pspecs):
        with pytest.raises(ValueError, match="unknown"):
            fn("bogus")


def test_logical_rules_match_reference():
    assert pcommon.DEFAULT_RULES == jcommon.DEFAULT_RULES
    axes = [("layers", "embed", "ff"), ("vocab", "embed"), ("batch",),
            ("embed", "heads", "head_dim"), (None, "experts", "ff"),
            ("cache_seq", "kv_heads"), ()]
    rules = jmesh.rules_for(MESHES["pod"], long_context=True)
    for ax in axes:
        assert _t(pcommon.logical_to_pspec(ax)) == _t(
            jcommon.logical_to_pspec(ax, dict(jcommon.DEFAULT_RULES)))
        assert _t(pcommon.logical_to_pspec(ax, rules)) == _t(
            jcommon.logical_to_pspec(ax, rules))
    x = torch.ones(2, 3)
    assert pcommon.shard(x, "batch", "embed") is x
    try:
        pcommon.set_rules({"embed": "model"})
        assert pcommon.get_rules()["embed"] == "model"
        assert _t(pcommon.logical_to_pspec(("embed",))) == ("model",)
    finally:
        pcommon.set_rules({})
    assert pcommon.get_rules() == pcommon.DEFAULT_RULES


def _reference_specs(cfg, rules):
    if is_whisper(cfg):
        shapes, logical = wh_abstract(cfg)
        specs = jax.tree.map(
            lambda ax: jcommon.logical_to_pspec(ax, rules), logical,
            is_leaf=lambda x: isinstance(x, tuple) and all(
                isinstance(e, (str, type(None))) for e in x))
        return shapes, specs
    return jtf.abstract_params(cfg)[0], jtf.param_pspecs(cfg, rules)


def _walk(port, ref_shapes, ref_specs, shape_tree, stacked=False):
    """(port spec, port shape, reference spec, reference shape, stacked)
    for every leaf, the port's per-layer leaves against the reference's
    stacked ones."""
    if isinstance(port, dict):
        for k in port:
            yield from _walk(port[k], ref_shapes[k], ref_specs[k],
                             shape_tree[k], stacked)
    else:
        yield port, tuple(shape_tree.shape), ref_specs, \
            tuple(ref_shapes.shape), stacked


def _leaves(arch, rules):
    jcfg = JArch(arch.name).cfg
    ref_shapes, ref_specs = _reference_specs(jcfg, rules)
    shapes = arch.abstract_params()[0]
    specs = arch.param_pspecs(rules)
    for k in specs:
        if k == "blocks":
            for row_s, row_p in zip(specs[k], shapes[k]):
                for i, (ls, lp) in enumerate(zip(row_s, row_p)):
                    yield from _walk(ls, ref_shapes[k][i], ref_specs[k][i],
                                     lp, True)
        elif k in ("enc", "dec"):
            for ls, lp in zip(specs[k], shapes[k]):
                yield from _walk(ls, ref_shapes[k], ref_specs[k], lp, True)
        else:
            yield from _walk(specs[k], ref_shapes[k], ref_specs[k],
                             shapes[k])


def _pad(ps, rank):
    return tuple(ps) + (None,) * (rank - len(ps))


@pytest.mark.parametrize("rules", ["default", "production", "pod"])
@pytest.mark.parametrize("name", NAMES)
def test_param_pspecs_match_reference(name, rules):
    """Every parameter of the config: the port's per-layer shape is the
    reference's stacked one without its leading layers axis, and its spec
    the reference's without the layers entry (which never splits)."""
    rule_set = (dict(jcommon.DEFAULT_RULES) if rules == "default"
                else jmesh.rules_for(MESHES[rules]))
    n = 0
    for ps, shape, jps, jshape, stacked in _leaves(Arch(name), rule_set):
        rank = len(shape)
        assert jshape == ((jshape[0],) + shape if stacked else shape)
        want = _pad(jps, rank + stacked)
        if stacked:
            assert want[0] is None
            want = want[1:]
        assert _pad(ps, rank) == want, (name, ps, jps)
        n += 1
    assert n > 0


def test_optimizer_state_pspecs_match_reference():
    """Sgd, AdamW and Adafactor state specs from olmo_1b's (reduced)
    parameter specs: the reference's, leaf for leaf (Adafactor's slots in
    the reference's stacked layout)."""
    arch = Arch("olmo_1b", reduced=True)
    jcfg = JArch("olmo_1b", reduced=True).cfg
    rules = jmesh.rules_for(MESHES["production"])
    pspecs, jspecs = arch.param_pspecs(rules), jtf.param_pspecs(jcfg, rules)
    is_p = dict(is_leaf=lambda x: isinstance(x, JP))
    for name in ("sgd", "adamw"):
        got = poptim.make_optimizer(name).state_pspecs(pspecs)
        want = joptim.make_optimizer(name).state_pspecs(jspecs)
        assert sorted(got) == sorted(want)
        for k in got:
            assert [_t(p) for p in _spec_leaves(got[k])] \
                == [_t(p) for p in jax.tree.leaves(
                    _unstack(want[k]), **is_p)]
    got = poptim.Adafactor().state_pspecs(pspecs)["slots"]
    want = jax.tree.leaves(joptim.Adafactor().state_pspecs(jspecs)["slots"],
                           is_leaf=lambda x: isinstance(x, dict)
                           and "vr" in x)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert {k: _t(v) for k, v in g.items()} == \
            {k: _t(v) for k, v in w.items()}


def _unstack(tree):
    """A reference spec tree with each stacked leaf's layers entry dropped
    (its per-layer spec, as the port holds it)."""
    out = dict(tree)
    out["blocks"] = [jax.tree.map(lambda p: JP(*tuple(p)[1:]), b,
                                  is_leaf=lambda x: isinstance(x, JP))
                     for b in tree["blocks"]]
    return out


def _spec_leaves(tree):
    """The port's spec leaves in the reference's leaf order (the first
    superblock's blocks standing for the stack)."""
    out = dict(tree)
    out["blocks"] = tree["blocks"][0]
    leaves = []

    def walk(node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        elif type(node) is list:
            for v in node:
                walk(v)
        else:
            leaves.append(node)
    walk(out)
    return leaves


def test_meshes_and_shims():
    """The mesh constructors give shape-only meshes without a process
    group of their size; the host-local mesh is the trivial (1,) one; the
    two shims re-export the dist modules."""
    prod = pmesh.make_production_mesh()
    assert pmesh.axis_sizes(prod) == {"data": 16, "model": 16}
    assert pmesh.axis_sizes(pmesh.make_production_mesh(multi_pod=True)) \
        == {"pod": 2, "data": 16, "model": 16}
    assert pmesh.axis_sizes(pmesh.make_debug_mesh(2, 2, pod=2)) == \
        {"pod": 2, "data": 2, "model": 2}
    assert pmesh.axis_sizes(pmesh.make_host_local_mesh("tables")) == \
        {"tables": 1}
    assert pmesh.local_shape((64, 32), P("data", "model"), prod) == (4, 2)
    from repro_torch.core import distributed as cd
    from repro_torch.dist import sketch_parallel as sp
    from repro_torch.launch import mesh as lm
    assert cd.update_table_sharded is sp.update_table_sharded
    assert lm.fsdp_tree is pmesh.fsdp_tree


def test_fsdp_tree_and_sharding_tree_on_a_config():
    """``fsdp_tree`` and ``sharding_tree_for`` over olmo_1b's parameters
    on the production mesh: each leaf what ``apply_fsdp`` then
    ``sanitize_pspec`` give it alone (the reference's per-leaf rules)."""
    arch = Arch("olmo_1b")
    mesh = MESHES["production"]
    shapes = arch.abstract_params()[0]
    specs = arch.param_pspecs(jmesh.rules_for(mesh))
    fsdp = pmesh.fsdp_tree(specs, shapes, mesh)
    placed = pmesh.sharding_tree_for(mesh, fsdp, shapes)
    flat = []
    pmesh.map_specs(lambda a, b, c, s: flat.append((a, b, c, s)), specs,
                    fsdp, placed, shapes)
    for ps, fs, pl, t in flat:
        shape = tuple(t.shape)
        assert _t(fs) == _t(jmesh.apply_fsdp(JP(*ps), shape, mesh))
        assert _t(pl) == _t(jmesh.sanitize_pspec(JP(*fs), shape, mesh))
    assert any("data" in _t(fs) for _, fs, _, _ in flat)
