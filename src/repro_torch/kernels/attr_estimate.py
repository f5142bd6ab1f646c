"""Attribution point-estimate kernel, two entry points on one source
(``csrc/attr_estimate.cu``).

* ``attr_estimate`` — the batch query: out[b] = median_r(signs[b, r] ·
  plane[r, cols[b, r]]) over the R signed rows of one level of an
  attribution hierarchy (``repro_torch.attribution``); odd R gives the
  middle order statistic, even R the midpoint ``0.5 * (a + b)`` of the two
  middles.  The post-mortem query (``attribution.estimate``) launches it.
* ``attr_find_hh`` — the whole findHH drill-down of one single-channel
  (NL, R, C) hierarchy in one launch (``attribution.find_hh``, once a
  chunk on the stream path), bitwise ``attr_find_hh_plain``, the loop of
  one ``attr_estimate`` and about twenty small PyTorch ops a level it
  replaces.

Replaces the TPU kernel ``repro.kernels.attr_estimate.attr_estimate``
(Pallas, in ``src/repro/kernels/attr_estimate.py``), and the drill-down
the reference runs around its estimates as one ``lax.scan``
(``repro.attribution.sketch.find_hh``).

Bound on the H100: launch latency for the batch query (by bytes, the
(B, R) columns and signs in, the (B,) estimates out and one read of each
plane cell touched); the drill-down is NL dependent round trips to L2,
one a level (by bytes ~0.03 µs).  The batch query is one thread per query
b: the R values sit in registers and a compare-exchange network sorts
them for R <= 8; any larger R takes an exact rank selection with no
array, so no R is refused.  The drill-down is one block, a child a
thread, the hierarchy staged in shared memory where it fits
(``find_hh_layout``), each child's slot in the beam its stable rank
among the 2W children.  Columns outside [0, C) are clamped, as the
reference's gather clamps.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

# The post-mortem batch query; its count is the module's launches.
KERNEL = build.Kernel("attr_estimate", "repro_attr_estimate",
                      [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3)
# The one-launch drill-down of the stream path.
FIND_HH_KERNEL = build.Kernel("attr_estimate", "repro_attr_find_hh",
                              [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6)

# The dynamic shared memory one block may ask for on sm_90 (H100, H200: 227
# KB), the only target the kernels are built for.
SMEM_PER_BLOCK = 232_448
# A beam lane's share of the drill-down's working memory: its key, flag
# and estimate, and its two children's id, flag, estimate and rank, 4
# bytes each (kBeamLaneBytes in the source).
BEAM_LANE_BYTES = 44


def median_lastaxis(x: torch.Tensor) -> torch.Tensor:
    """THE median of every estimate path (the plain version, the
    attribution tier's L2 estimate; the kernel computes the same): sort
    the last axis; odd R takes the middle order statistic, even R the
    midpoint ``0.5 * (a + b)`` of the two middles."""
    r = x.shape[-1]
    s = torch.sort(x, dim=-1).values
    if r % 2:
        return s[..., r // 2]
    return 0.5 * (s[..., r // 2 - 1] + s[..., r // 2])


def attr_estimate_plain(plane: torch.Tensor, cols: torch.Tensor,
                        signs: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch
    (``repro.kernels.ref.attr_estimate_ref``): gather, sign, median."""
    R, C = plane.shape
    c = torch.clamp(cols.long(), 0, C - 1)
    g = plane[torch.arange(R, device=plane.device)[None, :], c] * signs
    return median_lastaxis(g)


def attr_estimate(plane: torch.Tensor, cols: torch.Tensor,
                  signs: torch.Tensor) -> torch.Tensor:
    """plane (R, C) float32, cols (B, R) int32, signs (B, R) float32 ±1
    -> (B,) float32 median-of-rows signed estimates."""
    R, C = plane.shape
    B = cols.shape[0]
    build.check(plane, "plane", torch.float32, (R, C))
    build.check(cols, "cols", torch.int32, (B, R))
    build.check(signs, "signs", torch.float32, (B, R))
    if build.on_cpu(plane, cols, signs):
        return attr_estimate_plain(plane, cols, signs)
    out = torch.empty((B,), dtype=torch.float32, device=plane.device)
    if B:
        KERNEL(plane.device, plane.data_ptr(), cols.data_ptr(),
               signs.data_ptr(), out.data_ptr(), B, R, C)
    return out


def beam_width(topk: int) -> int:
    """W: the nodes the drill-down's beam keeps a level."""
    return max(2 * topk, 8)


def num_levels(dim: int) -> int:
    """NL of a hierarchy over ``dim`` coordinates: ceil(log2(dim)), at
    least 1 (``attribution.AttrConfig.num_levels``)."""
    return max(1, (dim - 1).bit_length())


def find_hh_layout(NL: int, R: int, C: int, topk: int) -> tuple[bool, bool]:
    """Where the drill-down kernel keeps its data, chosen by shape:
    (stage the (NL, R, C) plane in shared memory, keep the beam there).
    The beam takes ``BEAM_LANE_BYTES`` a lane and goes to a device
    workspace only when it alone exceeds a block's shared memory (topk in
    the thousands); the plane is staged where it fits beside the beam
    (NL = 13, R = 5, C = 256: 66.6 KB), and read from global memory
    otherwise (``bits`` up to 20)."""
    beam = BEAM_LANE_BYTES * beam_width(topk)
    plane = 4 * NL * R * C
    if beam > SMEM_PER_BLOCK:
        return plane <= SMEM_PER_BLOCK, False
    return plane + beam <= SMEM_PER_BLOCK, True


def level_estimate(plane: torch.Tensor, cols: torch.Tensor,
                   signs: torch.Tensor, nodes: torch.Tensor, level: int,
                   estimator=attr_estimate_plain) -> torch.Tensor:
    """Median-of-rows estimates of node ids at one level of an (NL, R, C)
    hierarchy with (NL, 2^NL, R) tables, through ``estimator``
    (``attr_estimate``'s signature).  Node ids are clamped into
    [0, 2^NL), as the reference's gather clamps."""
    nodes = torch.clamp(nodes.long(), 0, cols.shape[1] - 1)
    return estimator(plane[level].contiguous(), cols[level][nodes],
                     signs[level][nodes])


def top_indices(rank: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries, ties to the lower index (as
    ``jax.lax.top_k``), NaN above every number: a stable descending
    sort."""
    return torch.sort(rank, descending=True, stable=True).indices[:k]


def attr_find_hh_plain(plane: torch.Tensor, cols: torch.Tensor,
                       signs: torch.Tensor, dim: int, topk: int,
                       estimator=attr_estimate_plain):
    """The drill-down in plain PyTorch, a Python loop over the static
    depths 2 … NL (no data-dependent shapes, no host sync); ``estimator``
    takes each level's estimates (``ops.attr_estimate`` gives the old
    per-level composition, kept for timing only).

    A beam of W = max(2·topk, 8) nodes descends: each depth expands every
    candidate into its two children, masks those outside the tree or past
    ``dim``, estimates |v̂| at the level and keeps the top W.  After the
    leaf level the beam is ranked once more.  Returns (coords (topk,)
    int32, ests (topk,) float32 signed estimates, valid (topk,) bool)."""
    nl = plane.shape[0]
    d2 = 1 << nl
    topk = int(topk)
    if topk < 1:
        raise ValueError(f"topk must be >= 1, got {topk}")
    beam = beam_width(topk)
    dev = plane.device
    keys = torch.arange(beam, dtype=torch.int32, device=dev)
    valid = keys < 2                               # depth-1 nodes: {0, 1}
    for depth in range(2, nl + 1):
        children = torch.cat([2 * keys, 2 * keys + 1])          # (2W,)
        cvalid = torch.cat([valid, valid]) & (children < (1 << depth))
        # the node's first covered coordinate k·2^(NL−d) must be < dim
        cvalid &= children <= ((dim - 1) >> (nl - depth))
        cidx = torch.clamp(children, 0, d2 - 1)
        est = level_estimate(plane, cols, signs, cidx, depth - 1, estimator)
        top = top_indices(torch.where(cvalid, torch.abs(est),
                                      float("-inf")), beam)
        keys, valid = cidx[top], cvalid[top]
    valid = valid & (keys < dim)                   # leaf node == coordinate
    est = level_estimate(plane, cols, signs, keys, nl - 1, estimator)
    top = top_indices(torch.where(valid, torch.abs(est), float("-inf")),
                      topk)
    return keys[top], est[top], valid[top]


def attr_find_hh(plane: torch.Tensor, cols: torch.Tensor,
                 signs: torch.Tensor, dim: int, topk: int):
    """plane (NL, R, C) float32 single-channel hierarchy over ``dim``
    coordinates, cols (NL, 2^NL, R) int32 and signs (NL, 2^NL, R) float32
    ±1 node tables -> (coords (topk,) int32, ests (topk,) float32, valid
    (topk,) bool): the top ``topk`` of the findHH drill-down."""
    topk = int(topk)
    if topk < 1:
        raise ValueError(f"topk must be >= 1, got {topk}")
    NL, R, C = plane.shape
    if dim < 1 or num_levels(dim) != NL:
        raise ValueError(f"a hierarchy of {NL} levels does not cover "
                         f"dim={dim}")
    build.check(plane, "plane", torch.float32, (NL, R, C))
    build.check(cols, "cols", torch.int32, (NL, 1 << NL, R))
    build.check(signs, "signs", torch.float32, (NL, 1 << NL, R))
    if build.on_cpu(plane, cols, signs):
        return attr_find_hh_plain(plane, cols, signs, dim, topk)
    dev = plane.device
    coords = torch.empty((topk,), dtype=torch.int32, device=dev)
    ests = torch.empty((topk,), dtype=torch.float32, device=dev)
    valid = torch.empty((topk,), dtype=torch.bool, device=dev)
    stage, beam_in_smem = find_hh_layout(NL, R, C, topk)
    work = None if beam_in_smem else torch.empty(
        (BEAM_LANE_BYTES * beam_width(topk),), dtype=torch.uint8, device=dev)
    FIND_HH_KERNEL(dev, plane.data_ptr(), cols.data_ptr(), signs.data_ptr(),
                   coords.data_ptr(), ests.data_ptr(), valid.data_ptr(),
                   None if work is None else work.data_ptr(), NL, R, C, dim,
                   topk, int(stage))
    return coords, ests, valid
