"""SRP meta-hash kernel: (B, d) @ (d, P) -> sign -> big-endian K-bit pack
-> (B, L) int32 bucket ids.

Replaces the TPU kernel ``repro.kernels.srp_hash.srp_hash`` (Pallas, in
``src/repro/kernels/srp_hash.py``).  CUDA source: ``csrc/srp_hash.cu``
with the block hash ``csrc/srp_gemm.cuh``.

Bound on the H100: fp32 operations, 2·B·d·K·L FLOP against 67 TFLOP/s
(at the stream step's B=512, d=4097, K·L=416: 1.75 GFLOP, 26 µs); the
bytes of x, W and the ids are small beside them.  The design is a
register-tiled fp32 FMA product: blocks of (64 rows × a group of whole
tables ≤ 128 columns), 128 threads of 8 × 8 sums each, x and W slices
staged by ``cp.async`` in a 4-deep shared-memory ring; the depth is split
across the S blocks of a thread-block cluster, which add their partial
tiles in rank order through distributed shared memory (at S = 1 a plain
launch takes the signs straight from its registers), then take signs
and pack with a funnel shift, so the (B, K·L) projection never reaches
device memory and the ids are the same bits run to run.  No TF32: it
flips sign bits.  x and W may each be bfloat16 or float16.  A pair of one
2-byte type runs on the tensor-core tile (``hash_tile``: ``mma.sync``
m16n8k16, fp32 accumulation, under the same plan, split and epilogue): a
2-byte product is exact in fp32, but the tensor cores add in their own
order, so its ids are held to the dense floor (>= 0.999 agreement with the
plain version), not to the float32 kernel's bits.  A mixed pair runs on
the widening tile, which widens each element to float32 as it stages it,
so its ids are the float32 kernel's ids of the widened values.

``hash_plan`` is the launch plan both dense-hash wrappers (this one and
``ace_admit_fused``) give the kernel, whichever tile runs it: the row
tile, the table groups, the cluster size S and each split's depth range.
S is the largest whose clusters the card runs all at once, two blocks an
SM, as the card itself reports (its GPCs bound how many clusters fit).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from dataclasses import dataclass

import torch

from repro_torch.core.srp import SrpConfig, pack_buckets, srp_bits
from repro_torch.kernels import build

# The block shape of csrc/srp_gemm.cuh.
ROWS = 64            # rows of x a block (kRows)
COLS = 128           # projection columns a block (kCols)
SLICE = 16           # depth steps of one staged slice (kBK)
MAX_SPLITS = 8       # a portable cluster (kMaxSplits)

# The tiles of csrc/srp_gemm.cuh, in the order of their codes (TileCode).
TILES = ("float32", "widening", "tensor_core")

# Clusters of S = 1..8 blocks the H100 runs at once, two blocks an SM: its
# GPCs leave SMs out of every 8-block layer.  Asked of the card by
# ``device_clusters`` (chip_smoke.py prints it; NVIDIA H100 80GB HBM3);
# the CPU tests' stand-in for that query.
H100_CLUSTERS = (264, 132, 79, 62, 47, 39, 32, 30)

PLAN_ARGTYPES = [ctypes.c_int] * (5 + MAX_SPLITS + 1)
# The codes of x's and W's dtypes (build.OPERAND_DTYPES), after the plan,
# then the tile's (TILES).
OPERAND_ARGTYPES = [ctypes.c_int] * 2
TILE_ARGTYPES = [ctypes.c_int]

KERNEL = build.Kernel("srp_hash", "repro_srp_hash",
                      [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                      + PLAN_ARGTYPES + OPERAND_ARGTYPES + TILE_ARGTYPES)


def hash_tile(x_dtype: torch.dtype, w_dtype: torch.dtype) -> str:
    """The tile ``srp_hash`` and ``ace_admit_fused`` run an operand pair
    on (``srp_gemm.cuh`` ``route``): a float32 pair the float32 tile, a
    pair of one 2-byte type the tensor-core tile, a mixed pair the
    widening tile."""
    if x_dtype == w_dtype == torch.float32:
        return "float32"
    return "tensor_core" if x_dtype == w_dtype else "widening"


def tile_code(tile: str | None, x_dtype: torch.dtype,
              w_dtype: torch.dtype) -> int:
    """The code of ``tile`` (None: ``hash_tile``'s) for the pair; raises
    for a tile that does not take it.  Besides its own route, a pair with
    a 2-byte operand takes the widening tile when it is asked for by name
    (to time it beside the tensor-core tile); nothing falls back from one
    tile to another."""
    route = hash_tile(x_dtype, w_dtype)
    tile = tile or route
    if tile not in TILES:
        raise ValueError(f"tile must be one of {TILES}, got {tile!r}")
    if tile != route and (tile, route) != ("widening", "tensor_core"):
        raise ValueError(f"the {tile} tile does not take x {x_dtype} and "
                         f"W {w_dtype} (their tile: {route})")
    return TILES.index(tile)


@dataclass(frozen=True)
class HashPlan:
    """How the dense hash covers (B, d, K, L): ``row_tiles`` tiles of
    ``rows`` rows, ``groups`` groups of ``tables`` whole tables each (the
    last may hold fewer), and clusters of ``splits`` blocks, rank s of a
    cluster summing depth ``bounds[s]`` .. ``bounds[s + 1]``."""
    rows: int
    row_tiles: int
    tables: int
    groups: int
    splits: int
    bounds: tuple[int, ...]

    @property
    def blocks(self) -> int:
        return self.row_tiles * self.groups * self.splits

    @property
    def grid(self) -> tuple[int, int]:
        """The launch grid (x, y); clusters of ``splits`` blocks along x."""
        return self.splits * self.row_tiles, self.groups

    def args(self) -> tuple[int, ...]:
        """The plan as the C entry points take it."""
        pad = (0,) * (MAX_SPLITS + 1 - len(self.bounds))
        return (self.rows, self.row_tiles, self.tables, self.groups,
                self.splits, *self.bounds, *pad)

    def describe(self) -> str:
        return (f"{self.rows}-row tiles x {self.row_tiles}, {self.groups} "
                f"groups of {self.tables} tables, S={self.splits}, "
                f"{self.blocks} blocks")


def group_columns(g: int, tables: int, K: int, L: int) -> tuple[int, int]:
    """Columns [start, stop) of W that group g's tables own."""
    t0 = g * tables
    return t0 * K, min(L, t0 + tables) * K


def group_fits(g: int, tables: int, K: int, L: int) -> bool:
    """Whether group g's columns fit in one block's 128-column tile, which
    starts at the last 4-column boundary at or before its first column (W
    is read in 16-byte copies)."""
    start, stop = group_columns(g, tables, K, L)
    return stop - (start & ~3) <= COLS


def tables_per_group(K: int, L: int) -> int:
    """The most whole K-bit tables a group can hold, in every group."""
    build.check_bits(K)
    for t in range(min(L, COLS // K), 0, -1):
        if all(group_fits(g, t, K, L) for g in range(-(-L // t))):
            return t
    raise AssertionError("one table always fits")   # K <= 31 < COLS - 3


def split_bounds(d: int, splits: int) -> tuple[int, ...]:
    """Depth bounds of ``splits`` contiguous ranges over [0, d), each a
    whole number of slices but the last; a split may be empty."""
    n = -(-d // SLICE)
    return tuple(min(d, SLICE * (s * n // splits))
                 for s in range(splits + 1))


def make_plan(B: int, d: int, K: int, L: int, tables: int,
              splits: int) -> HashPlan:
    """The plan with the given group size and cluster size; raises for one
    the kernel cannot run."""
    if B < 1 or d < 1 or L < 1:
        raise ValueError(f"no plan for B={B}, d={d}, L={L}")
    build.check_bits(K)
    if not 1 <= splits <= MAX_SPLITS:
        raise ValueError(f"splits must be in [1, {MAX_SPLITS}], got "
                         f"{splits}")
    groups = -(-L // tables) if tables >= 1 else 0
    if tables < 1 or not all(group_fits(g, tables, K, L)
                             for g in range(groups)):
        raise ValueError(f"{tables} tables of {K} bits do not fit a "
                         f"{COLS}-column tile")
    if groups > 65535:
        raise ValueError(f"{groups} table groups exceed the grid")
    return HashPlan(ROWS, -(-B // ROWS), tables, groups, splits,
                    split_bounds(d, splits))


@functools.lru_cache(maxsize=256)
def hash_plan(B: int, d: int, K: int, L: int,
              clusters: tuple[int, ...]) -> HashPlan:
    """The plan for (B, d, K, L) on a card that runs ``clusters[S - 1]``
    clusters of S blocks at once, two blocks an SM.

    Groups hold as many whole tables as fit.  S is the largest cluster
    size that leaves every split at least one slice and whose clusters
    (one a row tile and group) the card runs all at once, two blocks an
    SM: the depth is split as far as one wave allows.  A grid too large
    for that even at S = 1 takes S = 1."""
    tables = tables_per_group(K, L)
    units = -(-B // ROWS) * -(-L // tables)
    slices = -(-d // SLICE)
    splits = max((s for s in range(1, MAX_SPLITS + 1)
                  if s <= slices and units <= clusters[s - 1]), default=1)
    return make_plan(B, d, K, L, tables, splits)


@functools.lru_cache(maxsize=16)
def device_clusters(device: torch.device) -> tuple[int, ...]:
    """``H100_CLUSTERS`` for the card that holds ``device``: asked of the
    kernel through ``cudaOccupancyMaxActiveClusters``, each block asking
    for the shared memory that leaves room for two blocks an SM."""
    per_sm = torch.cuda.get_device_properties(device) \
        .shared_memory_per_multiprocessor
    count = build.load("srp_hash").repro_srp_hash_max_clusters
    count.argtypes = [ctypes.c_int, ctypes.c_int,
                      ctypes.POINTER(ctypes.c_int)]
    count.restype = ctypes.c_int
    row = []
    for s in range(1, MAX_SPLITS + 1):
        n = ctypes.c_int(0)
        with torch.cuda.device(device):   # 1 KB a block is the card's
            err = count(s, per_sm // 2 - 1024, ctypes.byref(n))
        if err:
            raise RuntimeError(f"repro_srp_hash_max_clusters: CUDA error "
                               f"{err}")
        row.append(max(n.value, 1))
    return tuple(row)


def device_plan(B: int, d: int, K: int, L: int,
                device: torch.device) -> HashPlan:
    """``hash_plan`` for the card that holds ``device``'s tensors."""
    return hash_plan(B, d, K, L, device_clusters(device))


def lane_padded(w: torch.Tensor, cfg: SrpConfig) -> tuple[torch.Tensor, int]:
    """W as the dense-hash kernels read it, and its column count P.  A
    ``pad_lanes=False`` W has exactly K·L columns, a row stride the
    kernels' 16-byte W copies cannot follow (3000 bytes at K = 15, L = 50),
    so it is copied into round_up(K·L, 128) columns, zero-padded; the pad
    columns are never packed.  Any other W is returned as it is."""
    if cfg.pad_lanes:
        return w, cfg.padded_projections
    P = dataclasses.replace(cfg, pad_lanes=True).padded_projections
    return torch.nn.functional.pad(w, (0, P - w.shape[1])), P


def check_w_aligned(w: torch.Tensor) -> None:
    """The kernel reads W in 16-byte copies."""
    if w.data_ptr() % 16:
        raise ValueError("w: the dense hash kernel needs a 16-byte aligned "
                         "W (a fresh tensor, not a view at an odd offset)")


def srp_hash_plain(x: torch.Tensor, w: torch.Tensor,
                   cfg: SrpConfig) -> torch.Tensor:
    """The same function in plain PyTorch (``repro.kernels.ref.srp_hash_ref``):
    both operands widened to float32, as the widening tile and the
    reference's Pallas kernel widen them, then the float32 product.  On a
    CUDA tensor it is only exact with TF32 matmuls off
    (``torch.backends.cuda.matmul.allow_tf32 = False``, PyTorch's default)."""
    return pack_buckets(srp_bits(x.float(), w.float(), cfg), cfg)


def srp_hash(x: torch.Tensor, w: torch.Tensor, cfg: SrpConfig) -> torch.Tensor:
    """(B, d) @ (d, P) -> (B, L) int32 bucket ids in [0, 2^K).  x and W are
    each float32, bfloat16 or float16 (``build.OPERAND_DTYPES``), on the
    tile ``hash_tile`` picks for the pair."""
    return srp_hash_planned(x, w, cfg, None)


def srp_hash_planned(x: torch.Tensor, w: torch.Tensor, cfg: SrpConfig,
                     plan: HashPlan | None,
                     tile: str | None = None) -> torch.Tensor:
    """``srp_hash`` under a given launch plan (None: ``device_plan``'s)
    and tile (None: ``hash_tile``'s; see ``tile_code``); the plan changes
    nothing but the sum order of the depth splits."""
    B, d = x.shape
    K, L, P = cfg.num_bits, cfg.num_tables, cfg.padded_projections
    build.check_bits(K)
    build.check_operand(x, "x", (B, d))
    build.check_operand(w, "w", (d, P))
    code = tile_code(tile, x.dtype, w.dtype)
    if build.on_cpu(x, w):
        return srp_hash_plain(x, w, cfg)
    out = torch.empty((B, L), dtype=torch.int32, device=x.device)
    if B:
        w, P = lane_padded(w, cfg)
        check_w_aligned(w)
        plan = plan or device_plan(B, d, K, L, x.device)
        KERNEL(x.device, x.data_ptr(), w.data_ptr(), out.data_ptr(),
               B, d, P, K, L, *plan.args(),
               build.operand_code(x), build.operand_code(w), code)
    return out
