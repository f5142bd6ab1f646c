"""The three-term roofline over the dry run's artifacts (port of
``repro.dist.roofline``), with an NVIDIA H100 SXM5's rates: the numbers
come from shapes on the ``meta`` device (``repro_torch.launch.dryrun``),
no card runs.

Per cell (arch × shape × mesh JSON of ``launch.dryrun``):

    compute_s    = flops / PEAK_FLOPS           (tensor cores, dense bf16)
    memory_s     = bytes_accessed / HBM_BW      (HBM3)
    collective_s = Σ over mesh axes of that axis's collective bytes over
                   its link: NVLINK_BW where the axis's ranks fit in one
                   NODE_CARDS-card node, INTERNODE_BW where they span
                   nodes (a cell without a per-axis split: its total over
                   INTERNODE_BW)
    bound_s      = max of the three             (the roofline bound)

``useful_ratio`` = compute_s / bound_s.  The scan-corrected totals
(``corrected``) are preferred over the raw ones, as in the reference.

The rates are NVIDIA's H100 SXM5 datasheet figures: 989 TFLOP/s of
dense bf16 (1,979 with sparsity), 3.35 TB/s of HBM3, NVLink 4 at 900
GB/s a card in both directions together (450 each way) within an 8-card
HGX node, and one 400 Gb/s NDR InfiniBand port a card (50 GB/s) between
nodes.  They are module constants, so a caller (a test holding this
module to the reference's rows) can put other rates in their place.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os

PEAK_FLOPS = 989e12      # dense bf16 tensor cores, H100 SXM5
HBM_BW = 3.35e12         # bytes/s, HBM3
NVLINK_BW = 450e9        # bytes/s each way, within a node
INTERNODE_BW = 50e9      # bytes/s a card, NDR InfiniBand
NODE_CARDS = 8           # cards an NVLink domain (HGX H100)

# the production meshes' axes, major first, by the dry run's mesh names
MESH_AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}


@dataclasses.dataclass(frozen=True)
class RooflineRow:
    arch: str
    shape: str
    mesh: str
    compute_s: float
    memory_s: float
    collective_s: float
    bound_s: float
    useful_ratio: float
    dominant: str          # "compute" | "memory" | "collective"
    note: str


def mesh_axes(cell: dict) -> dict:
    """{axis: size} of a cell's mesh, major first: its ``mesh_axes``, else
    read from its name ("16x16", "2x16x16")."""
    if cell.get("mesh_axes"):
        return dict(cell["mesh_axes"])
    sizes = [int(x) for x in cell["mesh"].split("x")]
    return dict(zip(MESH_AXES.get(len(sizes), ()), sizes))


def link_bw(sizes: dict, axis: str) -> float:
    """The link an axis's collectives take: NVLink when its ranks (size ×
    the sizes of the axes minor to it, rank-major layout) fit in one node,
    else the inter-node rate."""
    names = list(sizes)
    if axis not in sizes:
        return INTERNODE_BW
    span = sizes[axis] * math.prod(sizes[a] for a in
                                   names[names.index(axis) + 1:])
    return NVLINK_BW if span <= NODE_CARDS else INTERNODE_BW


def collective_seconds(coll: dict, sizes: dict) -> float:
    by_axis = coll.get("by_axis")
    if by_axis is None:
        return float(coll.get("total_bytes", 0.0)) / INTERNODE_BW
    return sum(float(b) / link_bw(sizes, a) for a, b in by_axis.items())


def _kinds(coll: dict) -> list:
    """The collective kinds of a tally (its summary keys left out)."""
    return [k for k in coll if k not in ("total_bytes", "by_axis",
                                         "host_staged_bytes")]


def build_row(cell: dict) -> RooflineRow | None:
    """One dry-run JSON cell -> a RooflineRow (None for failed cells)."""
    if not cell.get("ok"):
        return None
    corr = cell.get("corrected") or {}
    flops = corr.get("flops", cell.get("flops")) or 0.0
    bytes_acc = corr.get("bytes_accessed", cell.get("bytes_accessed")) or 0.0
    coll = corr.get("collectives") or cell.get("collectives") or {}
    coll_bytes = float(coll.get("total_bytes", 0.0))

    compute_s = max(float(flops), 0.0) / PEAK_FLOPS
    memory_s = max(float(bytes_acc), 0.0) / HBM_BW
    collective_s = collective_seconds(coll, mesh_axes(cell))
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    bound_s = terms[dominant]
    useful = compute_s / bound_s if bound_s > 0 else 0.0

    kinds = _kinds(coll)
    kinds.sort(key=lambda k: -coll[k].get("bytes", 0))
    note = (f"top collective {kinds[0]}" if kinds and coll_bytes > 0
            else "no collective traffic")
    return RooflineRow(
        arch=cell["arch"], shape=cell["shape"], mesh=cell["mesh"],
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        bound_s=bound_s, useful_ratio=useful, dominant=dominant, note=note)


def build_all(results_dir: str) -> list[RooflineRow]:
    """All rows from ``<results_dir>/*.json``, sorted arch/shape/mesh."""
    rows = []
    for name in sorted(os.listdir(results_dir)):
        if not name.endswith(".json"):
            continue
        with open(os.path.join(results_dir, name)) as f:
            row = build_row(json.load(f))
        if row is not None:
            rows.append(row)
    rows.sort(key=lambda r: (r.arch, r.shape, r.mesh))
    return rows


def format_table(rows: list[RooflineRow]) -> str:
    """Markdown table of the three-term model."""
    out = ["| arch | shape | mesh | compute_s | memory_s | collective_s "
           "| bound_s | dominant | useful |",
           "|" + "---|" * 9]
    for r in rows:
        out.append(
            f"| {r.arch} | {r.shape} | {r.mesh} | {r.compute_s:.4f} | "
            f"{r.memory_s:.4f} | {r.collective_s:.4f} | {r.bound_s:.4f} | "
            f"{r.dominant} | {r.useful_ratio:.3f} |")
    if not rows:
        out.append("| (no dry-run artifacts) | - | - | - | - | - | - | - "
                   "| - |")
    return "\n".join(out)
