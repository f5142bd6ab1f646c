"""The port's dry run (``repro_torch.launch.dryrun``, ``dist.roofline``,
``Arch.input_specs`` / ``decode_pos_spec`` / ``cache_specs`` /
``cache_pspecs``, ``all_cells``) held to the reference.

The reference's own dry run does not run on this jax (its explicit-axes
``with_sharding_constraint`` asserts 0.8 s into a cell, ROADMAP queue 3
item 5), so the port is held to the reference's pure helpers: the
abstract inputs and caches of every config at full size (shapes and
dtypes; the reference's caches stacked over superblocks, the port's one a
layer), the cache specs, the cell list, ``cell_policy`` and
``_per_token_recompute_bytes`` on stub production meshes, and
``build_row`` with the reference's rates swapped in.  One cell runs end to
end through ``main`` on ``meta``, and every extrapolation of the probes
(depth, microbatches, sequence length with the data filter's sampling)
is held equal to a direct run of the cell's program on ``meta``.  The
step's collectives on ``meta`` are held to a live tally in
``tests/test_torch_dist_train_features.py``.

Importing ``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 host devices:
jax's backend is brought up first (so this process keeps its one device)
and the variable is put back after the import (so no subprocess a later
test starts inherits it).
"""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

jax.devices()
_saved = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as jdry  # noqa: E402
if _saved is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _saved

from repro.configs import list_archs  # noqa: E402
from repro.dist import mesh as jmesh  # noqa: E402
from repro.dist import roofline as jroof  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.common import logical_to_pspec as jlogical  # noqa: E402
from repro.models.registry import Arch as JArch  # noqa: E402
from repro.models.registry import all_cells as jall_cells  # noqa: E402
from repro.models.registry import is_whisper as jis_whisper  # noqa: E402
from repro_torch.dist import mesh as pmesh  # noqa: E402
from repro_torch.dist import roofline as proof  # noqa: E402
from repro_torch.launch import dryrun as pdry  # noqa: E402
from repro_torch.models.registry import (SHAPES, Arch, all_cells,  # noqa: E402
                                         leaves)
from repro_torch.train.fault import GradMonitor  # noqa: E402


class _MeshStub:
    """What the helpers read of a mesh: axis names and the device grid's
    shape (the reference test's stub)."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.zeros(shape)


MESHES = {"16x16": _MeshStub((16, 16), ("data", "model")),
          "2x16x16": _MeshStub((2, 16, 16), ("pod", "data", "model"))}
ARCHS = list_archs()


def _sig(t):
    """(shape, dtype name) of a jax ShapeDtypeStruct or a torch tensor."""
    return tuple(t.shape), str(t.dtype).replace("torch.", "")


def _pad(ps, rank):
    """A spec's entries padded to ``rank``, a one-axis tuple as its axis
    (jax's ``PartitionSpec`` stores ``("data",)`` as ``"data"``)."""
    entries = tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                    for e in ps)
    return entries + (None,) * (rank - len(entries))


def _port_cache_columns(cache, whisper):
    """The port's cache as the reference's stacked leaves: one list of
    per-layer tensors a reference leaf, in the reference's leaf order."""
    if whisper:
        return ([[kv.k for kv in cache.self_kv], [kv.v for kv in
                                                  cache.self_kv]],
                [cache.cross_k], [cache.cross_v])
    return [[list(col) for col in zip(*(list(leaves(row[i]))
                                        for row in cache))]
            for i in range(len(cache[0]))]


@pytest.mark.parametrize("name", ARCHS)
def test_specs_match_reference(name):
    """Every shape cell of the config at full size: ``input_specs`` and
    ``decode_pos_spec`` equal the reference's in shape and dtype, on
    ``meta``; a decode cell's ``cache_specs`` is the reference's cache,
    stacked leaf by leaf over the superblocks (whisper: its layers), and
    ``cache_pspecs`` the reference's specs without the layers entry, on
    both production meshes' rules (long-context ones included)."""
    arch, jarch = Arch(name), JArch(name)
    whisper = jis_whisper(jarch.cfg)
    for sname, shape in SHAPES.items():
        got = arch.input_specs(shape)
        want = jarch.input_specs(shape)
        assert sorted(got) == sorted(want)
        for k in got:
            assert got[k].device.type == "meta"
            assert _sig(got[k]) == _sig(want[k]), (name, sname, k)
        assert _sig(arch.decode_pos_spec(shape, batch_override=3)) \
            == _sig(jarch.decode_pos_spec(shape, batch_override=3))
        if shape.kind != "decode" or not arch.supports(sname):
            continue
        cache = arch.cache_specs(shape)
        assert all(t.device.type == "meta" for t in leaves(cache))
        jcache = jarch.cache_specs(shape)
        columns = _port_cache_columns(cache, whisper)
        jcols = ([jcache.self_kv.k, jcache.self_kv.v], [jcache.cross_k],
                 [jcache.cross_v]) if whisper else [
            jax.tree.leaves(c) for c in jcache]
        for col, jcol in zip(columns, jcols):
            for parts, jleaf in zip(col, jcol):
                shapes = {_sig(t) for t in parts}
                assert len(shapes) == 1
                (shp, dt), = shapes
                assert (len(parts),) + shp == tuple(jleaf.shape)
                assert dt == str(jleaf.dtype)
        for mname, stub in MESHES.items():
            long_ctx = sname == "long_500k"
            rules = jmesh.rules_for(stub, long_context=long_ctx)
            got_ps = arch.cache_pspecs(long_context=long_ctx, rules=rules)
            if whisper:
                kv = jlogical(("layers", "batch", "cache_seq", "kv_heads",
                               "head_dim"), rules)
                want_ps = [[kv, kv]] * 1 + [[kv], [kv]]
                mine = [[got_ps.self_kv[0].k, got_ps.self_kv[0].v],
                        [got_ps.cross_k[0]], [got_ps.cross_v[0]]]
            else:
                want_ps = [jax.tree.leaves(
                    c, is_leaf=lambda x: isinstance(x, jax.sharding
                                                    .PartitionSpec))
                    for c in jtf.cache_pspecs(jarch.cfg,
                                              long_context=long_ctx,
                                              rules=rules)]
                mine = [list(pmesh.map_specs(lambda p: p, got_ps[0][i]))
                        for i in range(len(got_ps[0]))]
                for row in got_ps:      # every superblock alike
                    assert [list(e) for e in row] \
                        == [list(e) for e in got_ps[0]]
            for jrow, prow, ref in zip(want_ps, mine, jcols):
                for jps, ps, jleaf in zip(jrow, prow, ref):
                    rank = len(jleaf.shape)
                    want = _pad(jps, rank)
                    assert want[0] is None
                    assert _pad(ps, rank - 1) == want[1:], (name, mname)


def test_all_cells_match_reference():
    """The cell list both ways, in the reference's order: 35 cells, 40
    with the long-context cells the full-attention archs skip."""
    assert all_cells() == jall_cells()
    assert all_cells(include_skipped=True) == \
        jall_cells(include_skipped=True)
    assert (len(all_cells()), len(all_cells(True))) == (35, 40)


@pytest.mark.parametrize("name", ARCHS)
def test_cell_policy_matches_reference(name):
    """``cell_policy`` of every shape cell of the config (serving cells in
    bf16, as ``run_cell`` builds them) on both production meshes, and
    ``_per_token_recompute_bytes`` at each shape's sequence length and at
    three model-axis widths: exactly the reference's."""
    for sname, shape in SHAPES.items():
        arch, jarch = Arch(name), JArch(name)
        if shape.kind != "train":
            arch.cfg = dataclasses.replace(arch.cfg, param_dtype="bfloat16")
            jarch.cfg = dataclasses.replace(jarch.cfg,
                                            param_dtype="bfloat16")
        for stub in MESHES.values():
            assert dataclasses.asdict(pdry.cell_policy(arch, shape, stub)) \
                == dataclasses.asdict(jdry.cell_policy(jarch, shape, stub))
        for shards in (1, 4, 16):
            assert pdry._per_token_recompute_bytes(
                arch.cfg, shape.seq_len, shards) \
                == jdry._per_token_recompute_bytes(jarch.cfg, shape.seq_len,
                                                   shards)
    assert (pdry.ACTIVATION_BUDGET, pdry.BIG_MODEL_PARAMS) \
        == (jdry.ACTIVATION_BUDGET, jdry.BIG_MODEL_PARAMS)


def _reference_cell(**over):
    coll = {"all-gather": {"bytes": 3.0e9, "count": 12},
            "all-reduce": {"bytes": 5.0e8, "count": 40},
            "total_bytes": 3.5e9}
    cell = {"arch": "olmo_1b", "shape": "train_4k", "mesh": "16x16",
            "ok": True, "flops": 1.0e14, "bytes_accessed": 2.0e12,
            "collectives": coll,
            "corrected": {"flops": 7.0e14, "bytes_accessed": 3.0e12,
                          "collectives": coll}}
    cell.update(over)
    return cell


def _row(r):
    return None if r is None else dataclasses.asdict(r)


@pytest.fixture
def reference_rates(monkeypatch):
    """The port's roofline with the reference's TPU v5e rates (both of its
    links at the ICI rate)."""
    monkeypatch.setattr(proof, "PEAK_FLOPS", jroof.PEAK_FLOPS)
    monkeypatch.setattr(proof, "HBM_BW", jroof.HBM_BW)
    monkeypatch.setattr(proof, "NVLINK_BW", jroof.ICI_BW)
    monkeypatch.setattr(proof, "INTERNODE_BW", jroof.ICI_BW)


def test_build_row_matches_reference(reference_rates, tmp_path):
    """``build_row`` on the reference's cell layout (with and without the
    probe's totals, memory-, compute- and collective-bound, no
    collectives, a failed cell) equals the reference's row field for
    field; on the port's own cell (its per-axis bytes) within 1e-12 of the
    reference's row of the same cell without them; ``format_table`` the
    same text."""
    cells = [_reference_cell(), _reference_cell(corrected=None),
             _reference_cell(flops=1e20, corrected=None),
             _reference_cell(corrected={"collectives": {
                 "all-gather": {"bytes": 9e14, "count": 1},
                 "total_bytes": 9e14}}),
             _reference_cell(collectives={}, corrected=None),
             _reference_cell(ok=False)]
    for cell in cells:
        assert _row(proof.build_row(cell)) == _row(jroof.build_row(cell))
    rows = [proof.build_row(c) for c in cells if c["ok"]]
    assert proof.format_table(rows) == jroof.format_table(
        [jroof.build_row(c) for c in cells if c["ok"]])

    cell = dataclasses.asdict(pdry.run_cell("whisper_tiny", "train_4k",
                                            False))

    def strip(coll):
        return {k: v for k, v in coll.items()
                if k not in ("by_axis", "host_staged_bytes")}
    stripped = dict(cell, collectives=strip(cell["collectives"]),
                    corrected=dict(cell["corrected"], collectives=strip(
                        cell["corrected"]["collectives"])))
    got, want = proof.build_row(cell), jroof.build_row(stripped)
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert a == pytest.approx(b, rel=1e-12) if isinstance(a, float) \
            else a == b


def test_rates_are_the_h100s():
    """The module's rates: NVIDIA's H100 SXM5 datasheet figures, an axis
    within one 8-card node on NVLink and one across nodes on InfiniBand."""
    assert (proof.PEAK_FLOPS, proof.HBM_BW, proof.NVLINK_BW,
            proof.INTERNODE_BW, proof.NODE_CARDS) == (989e12, 3.35e12,
                                                      450e9, 50e9, 8)
    sizes = {"data": 2, "model": 4}
    assert proof.link_bw(sizes, "model") == proof.NVLINK_BW
    assert proof.link_bw(sizes, "data") == proof.NVLINK_BW
    sizes = {"data": 16, "model": 16}
    assert proof.link_bw(sizes, "model") == proof.INTERNODE_BW
    assert proof.link_bw({"data": 4, "model": 4}, "data") \
        == proof.INTERNODE_BW


def test_main_runs_a_cell_on_both_meshes(tmp_path, capsys):
    """``python -m repro_torch.launch.dryrun --arch whisper_tiny --shape
    train_4k --both-meshes`` on ``meta`` (the reference's TestDryrunEntry
    contract): both files written, ``ok``, collectives moved, every
    figure positive; a parameter block and the AdamW moments counted in
    ``memory.args`` exactly; the roofline reads both."""
    out = tmp_path / "dry"
    pdry.main(["--arch", "whisper_tiny", "--shape", "train_4k",
               "--both-meshes", "--out", str(out)])
    import json
    names = sorted(os.listdir(out))
    assert names == ["whisper_tiny__train_4k__16x16.json",
                     "whisper_tiny__train_4k__2x16x16.json"]
    for name in names:
        cell = json.loads((out / name).read_text())
        assert cell["ok"], cell["error"]
        assert cell["collectives"]["total_bytes"] > 0
        assert cell["flops"] > 0 and cell["bytes_accessed"] > 0
        assert cell["params"] == JArch("whisper_tiny").param_count()
        mesh = pmesh.MeshShape(tuple(cell["mesh_axes"].values()),
                               tuple(cell["mesh_axes"]))
        arch = Arch("whisper_tiny")
        pmesh_rules = pmesh.rules_for(mesh)
        shapes = arch.abstract_params()[0]
        specs = pmesh.sharding_tree_for(mesh, pmesh.fsdp_tree(
            arch.param_pspecs(pmesh_rules), shapes, mesh), shapes)
        blocks = []
        pmesh.map_specs(lambda ps, t: blocks.append(int(np.prod(
            pmesh.local_shape(t.shape, ps, mesh))) * t.element_size()),
            specs, shapes)
        batch = sum(t.numel() * t.element_size() for t in
                    arch.input_specs(SHAPES["train_4k"]).values())
        monitor = sum(t.numel() * t.element_size() for t in leaves(
            GradMonitor(feature_dim=32, device=torch.device("meta")).init()))
        # a rank's fp32 parameter blocks and AdamW's m and v beside them,
        # the global batch (whisper trains with no data filter), the
        # monitor's sketch and projections whole, the step counter
        assert cell["memory"]["args"] == 3 * sum(blocks) + batch \
            + monitor + 4
    rows = proof.build_all(str(out))
    assert [r.mesh for r in rows] == ["16x16", "2x16x16"]
    assert proof.format_table(rows).count("| whisper_tiny |") == 2
    assert "OK" in capsys.readouterr().out


MESH_2X2 = pmesh.MeshShape((2, 2), ("data", "model"))


def _depth(name: str, n_sb: int) -> Arch:
    arch = Arch(name, reduced=True)
    arch.cfg = dataclasses.replace(
        arch.cfg, num_layers=n_sb * len(arch.cfg.block_pattern))
    return arch


def _direct(arch, shape, depth, tcfg=None):
    """One direct run of the cell's program on ``MESH_2X2`` at ``depth``
    superblocks and ``shape``'s length: a train cell's step whole, every
    microbatch run (``step_on_meta``), a serving cell's ``cell_costs``."""
    from repro_torch.train import sharded
    rules = pmesh.rules_for(MESH_2X2)
    before = pdry.get_rules()
    pdry.set_rules(rules)
    try:
        a = pdry._probe(arch, shape, depth)
        if shape.kind != "train":
            rows = pdry._local_rows(shape.global_batch, MESH_2X2, rules,
                                    False)
            return pdry.cell_costs(a, shape, MESH_2X2, rules, False, rows)
        c = pdry.Costs()
        coll = sharded.step_on_meta(a, tcfg, pdry._param_specs(
            a, MESH_2X2, rules), None, MESH_2X2, a.input_specs(shape),
            count=c)
        return c.flops, c.bytes, coll
    finally:
        pdry.set_rules(before)


@pytest.mark.parametrize("kind", ["train", "prefill"])
@pytest.mark.parametrize("name", ["jamba_v01_52b", "rwkv6_7b"])
def test_probes_extrapolate_exactly(name, kind, monkeypatch):
    """Reduced Jamba and RWKV-6 at 3 superblocks, S = 16, on a (2, 2)
    mesh, the probes' step set to 4 tokens (their cost on ``meta`` grows
    with the time steps; the fit's exactness does not depend on the
    step): the dry run's totals, from probes at 1 and 2 superblocks and at
    4, 8 and 12 tokens (``seq_probes``, the degree-2 fit, then the depth
    extrapolation), equal one direct run of the cell's program at 3
    superblocks and 16 tokens exactly: flops, bytes and every
    collective's bytes and calls."""
    monkeypatch.setattr(pdry, "SEQ_PROBE", 4)
    arch = _depth(name, 3)
    shape = pdry.ShapeSpec(f"{kind}_16", 16, 4, kind)
    cell = pdry.dry_run(arch, shape, MESH_2X2)
    assert cell.ok, cell.error
    assert cell.corrected["probe_depth1"]["seq_lens"] == [4, 8, 12]
    tcfg = pdry._train_tcfg(arch, pdry.CellPolicy(**cell.policy)) \
        if kind == "train" else None
    flops, nbytes, coll = _direct(arch, shape, 3, tcfg)
    assert flops > 0 and coll["total_bytes"] > 0
    assert (cell.flops, cell.bytes_accessed) == (flops, nbytes)
    assert cell.collectives == coll


def test_filter_and_microbatch_probes_are_exact():
    """Reduced olmo_1b on a (2, 2) mesh.  The data filter's fourth probe:
    one superblock's step at 64, 128, 192 (every token scored) and 512
    tokens (every second), fitted by ``_fit``, gives its flops and bytes
    at 1024 tokens (every fourth) exactly.  The microbatch probes: a
    train cell of 4 microbatches of 2 rows a rank at 3 superblocks, whose
    totals come from steps of one and two microbatches at 1 and 2
    superblocks, equals the whole step run directly exactly."""
    from repro_torch.train.train_loop import filter_tokens
    arch = _depth("olmo_1b", 1)
    tcfg = pdry._train_tcfg(arch, pdry.CellPolicy("adamw", 1))
    lengths = (64, 128, 192, 512)
    assert [filter_tokens(L) for L in lengths + (1024,)] \
        == [64, 128, 192, 256, 256]
    runs = [_direct(arch, pdry.ShapeSpec("t", L, 4, "train"), 1, tcfg)
            for L in lengths]
    want = _direct(arch, pdry.ShapeSpec("t", 1024, 4, "train"), 1, tcfg)
    for i in (0, 1):
        assert pdry._fit(lengths, [r[i] for r in runs], 1024) == want[i]
    # the fourth probe is needed: the quadratic alone misses
    assert pdry._quadratic(lengths[:3], [r[1] for r in runs[:3]], 1024) \
        != want[1]

    arch = _depth("olmo_1b", 3)
    shape = pdry.ShapeSpec("train_mb4", 64, 16, "train")
    policy = pdry.CellPolicy("adamw", 4)
    tcfg = pdry._train_tcfg(arch, policy)
    cell = pdry.dry_run(arch, shape, MESH_2X2, policy=policy, tcfg=tcfg)
    assert cell.ok, cell.error
    flops, nbytes, coll = _direct(arch, shape, 3, tcfg)
    assert (cell.flops, cell.bytes_accessed) == (flops, nbytes)
    assert cell.collectives == coll


def test_collectives_over_a_mesh_shape_tally_and_do_not_run():
    """Over a ``MeshShape`` each wrapper takes ``meta`` tensors, returns a
    tensor of its result's shape on ``meta`` and tallies what a live call
    would (rank 0's view, an axis of one rank skipped); a CPU tensor
    raises."""
    from repro_torch.dist import collectives as col
    mesh = pmesh.MeshShape((2, 4), ("data", "model"))
    x = torch.empty((4, 6), device="meta")
    with col.tallied() as tally:
        assert tuple(col.all_gather(x, mesh, "model", dim=1).shape) == (4, 24)
        assert tuple(col.reduce_scatter(x, mesh, "data", dim=0).shape) \
            == (2, 6)
        assert col.all_reduce(x, mesh, ("data", "model")) is x
        assert tuple(col.permute(x, mesh, "model").shape) == (4, 6)
        col.broadcast(x, mesh)
        col.all_reduce(x, pmesh.MeshShape((1, 4), ("data", "model")),
                       "data")
    snap = tally.snapshot()
    assert snap["all-gather"] == {"bytes": 4 * 4 * 6 * 4, "count": 1}
    assert snap["reduce-scatter"] == {"bytes": 2 * 6 * 4, "count": 1}
    assert snap["all-reduce"] == {"bytes": 2 * 96, "count": 2}
    assert snap["collective-permute"] == {"bytes": 96, "count": 1}
    assert snap["broadcast"] == {"bytes": 96, "count": 1}
    assert snap["by_axis"] == {"model": 384 + 96 + 96, "data": 48 + 96,
                               "*": 96}
    assert mesh.get_local_rank("model") == 0
    with pytest.raises(ValueError, match="meta"):
        col.all_reduce(torch.zeros(3), mesh, "data")


def test_kernels_take_meta_only_within_plain_on_meta():
    """A kernel wrapper refuses ``meta`` tensors, and within
    ``build.plain_on_meta`` runs its plain version on their shapes."""
    from repro_torch.core.srp import SrpConfig
    from repro_torch.kernels import build
    from repro_torch.kernels import ops as kops
    cfg = SrpConfig(dim=16, num_bits=8, num_tables=4)
    x = torch.empty((5, 17), device="meta")
    w = torch.empty((17, cfg.padded_projections), device="meta")
    with pytest.raises(ValueError, match="meta"):
        kops.srp_hash(x, w, cfg)
    with build.plain_on_meta():
        ids = kops.srp_hash(x, w, cfg)
    assert ids.device.type == "meta" and tuple(ids.shape) == (5, 4)
    with pytest.raises(ValueError, match="meta"):
        kops.srp_hash(x, w, cfg)
