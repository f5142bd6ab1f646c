"""Attribution point-estimate kernel: out[b] = median_r(signs[b, r] ·
plane[r, cols[b, r]]) over the R signed rows of one level of an
attribution hierarchy (``repro_torch.attribution``); odd R gives the middle
order statistic, even R the midpoint ``0.5 * (a + b)`` of the two middles.

Replaces the TPU kernel ``repro.kernels.attr_estimate.attr_estimate``
(Pallas, in ``src/repro/kernels/attr_estimate.py``).  CUDA source:
``csrc/attr_estimate.cu``.

Bound on the H100: launch latency at the shapes the attribution path gives
it (2W = 16-32 beam children a level, or a few thousand leaf coordinates);
by bytes, the (B, R) columns and signs in, the (B,) estimates out and one
read of each plane cell touched.  The design is one thread per query b:
the R values sit in registers and a compare-exchange network sorts them
for R <= 8; any larger R takes an exact rank selection with no array, so
no R is refused.  Columns outside [0, C) are clamped, as the reference's
gather clamps.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

KERNEL = build.Kernel("attr_estimate", "repro_attr_estimate",
                      [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3)


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
