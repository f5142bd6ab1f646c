"""Deterministic fault injectors for the chaos suite — port of
``repro.resilience.inject``.

The reference draws its faults with ``jax.random`` keys, which torch
cannot reproduce; the injectors here that draw take an explicit
``torch.Generator`` instead (as ``core.srp.make_projections`` does), so a
chaos run is a replayable program: the same seed gives the same
corruption, the same health verdict and the same degraded scores.  To
hold the port against the reference, carry a faulted state across
(``core.convert``) rather than re-draw the fault.

* poisoned input     — :func:`corrupt_embeddings` (NaN/Inf feature rows)
* memory corruption  — :func:`flip_count_bits` (single-bit flips in a
                       same-width view of a count plane, any counter
                       dtype) and :func:`saturate_table` (stuck-at-max)
* moment poisoning   — :func:`poison_moments` (NaN / negative M2)
* torn checkpoint    — :func:`tear_checkpoint` (truncate or byte-flip a
                       saved step's array blob on disk; numpy and ``os``
                       only, byte for byte the reference's)
* straggler          — :func:`stall_step` (rewind a ``StepTimer``)

Injectors on device state are pure (state in, state out); the disk and
host ones mutate exactly the object they are handed.
"""
from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import torch

# the same-width signed view of each counter itemsize, and its bit width
_VIEWS = {1: (torch.int8, 8), 2: (torch.int16, 16), 4: (torch.int32, 32)}


def _bits_of(dtype: torch.dtype) -> tuple:
    """(same-width integer view dtype, bit width) of a plane dtype."""
    return _VIEWS[torch.empty((), dtype=dtype).element_size()]


def _uniform(generator: torch.Generator, shape) -> torch.Tensor:
    return torch.rand(shape, generator=generator, device=generator.device)


def _randint(generator: torch.Generator, low: int, high: int,
             shape) -> torch.Tensor:
    return torch.randint(low, high, shape, generator=generator,
                         device=generator.device)


def corrupt_embeddings(x: torch.Tensor, generator: torch.Generator,
                       frac: float = 0.1, kind: str = "nan"):
    """Poison a fraction of feature rows with non-finite values.

    Returns ``(corrupted, bad_rows)``, ``bad_rows`` the (B,) bool mask of
    poisoned rows.  ``kind``: ``"nan"``, ``"inf"``, or ``"mixed"`` (NaN on
    even rows, Inf on odd ones)."""
    if kind not in ("nan", "inf", "mixed"):
        raise ValueError(f"unknown kind {kind!r}")
    B = x.shape[0]
    row = (B,) + (1,) * (x.ndim - 1)
    bad_rows = (_uniform(generator, (B,)) < frac).to(x.device)
    if kind == "nan":
        poison = torch.full_like(x, float("nan"))
    elif kind == "inf":
        poison = torch.full_like(x, float("inf"))
    else:
        even = torch.arange(B, device=x.device) % 2 == 0
        alt = torch.where(even, float("nan"), float("inf"))
        poison = alt.reshape(row).expand(x.shape).to(x.dtype)
    return torch.where(bad_rows.reshape(row), poison, x), bad_rows


def flip_count_bits(counts: torch.Tensor, generator: torch.Generator,
                    num_flips: int = 1,
                    tables: Sequence[int] | None = None) -> torch.Tensor:
    """Flip ``num_flips`` random bits in a count plane whose axis before
    the bucket axis indexes tables ((L, B) flat, (E, L, B) windowed,
    (T, L, B) fleet, (T, E, L, B) windowed fleet).

    Works on every counter dtype through a same-width integer view
    (int8/int16/int32 planes and float32 ones alike), so a sign- or
    high-bit flip gives exactly the garbage memory corruption would; the
    top bit's mask is the view's minimum, so it wraps rather than
    overflowing.  With ``tables``, flips land only in those tables (of a
    leading tenant/epoch slice drawn uniformly)."""
    view_dtype, width = _bits_of(counts.dtype)
    flat = counts.contiguous().reshape(-1).view(view_dtype).clone()
    if tables is None:
        idx = _randint(generator, 0, flat.shape[0], (num_flips,))
    else:
        *lead, L, buckets = counts.shape
        nlead = int(np.prod(lead)) if lead else 1
        choice = torch.as_tensor(list(tables), dtype=torch.int64,
                                 device=generator.device)
        t = choice[_randint(generator, 0, choice.shape[0], (num_flips,))]
        li = _randint(generator, 0, nlead, (num_flips,))
        off = _randint(generator, 0, buckets, (num_flips,))
        idx = (li * L + t) * buckets + off
    bit = _randint(generator, 0, width, (num_flips,))
    mask = torch.bitwise_left_shift(torch.ones_like(bit), bit)
    mask = torch.where(mask >= 2 ** (width - 1), mask - 2 ** width, mask)
    idx = idx.to(counts.device)
    flat[idx] = flat[idx] ^ mask.to(device=counts.device, dtype=view_dtype)
    return flat.view(counts.dtype).reshape(counts.shape)


def saturate_table(counts: torch.Tensor, table: int) -> torch.Tensor:
    """Stuck-at-max fault: every counter of one table pinned to the
    dtype's maximum (int) or 2^31 (float planes)."""
    top = 2.0 ** 31 if counts.dtype.is_floating_point \
        else torch.iinfo(counts.dtype).max
    out = counts.clone()
    out[table] = top
    return out


def poison_moments(state, kind: str = "nan"):
    """Corrupt the Welford stream of any ACE state type: ``"nan"`` poisons
    mean and M2 with NaN, ``"neg"`` makes M2 negative."""
    if kind == "nan":
        return state._replace(
            welford_mean=torch.full_like(state.welford_mean, float("nan")),
            welford_m2=torch.full_like(state.welford_m2, float("nan")))
    if kind == "neg":
        return state._replace(welford_m2=-torch.abs(state.welford_m2) - 1.0)
    raise ValueError(f"unknown kind {kind!r}")


def tear_checkpoint(ckpt_dir: str, step: int, mode: str = "truncate",
                    nbytes: int = 64, seed: int = 0) -> str:
    """Corrupt a saved checkpoint step on disk.  Returns the path of the
    torn blob.

    ``"truncate"`` chops the last ``nbytes`` off ``arrays.npz``;
    ``"flip"`` XOR-flips ``nbytes`` bytes at offsets drawn with numpy from
    ``seed``.  The manifest stays intact, so only its checksums catch it.
    """
    path = os.path.join(ckpt_dir, f"step_{step:010d}", "arrays.npz")
    size = os.path.getsize(path)
    if mode == "truncate":
        with open(path, "r+b") as f:
            f.truncate(max(size - nbytes, 0))
    elif mode == "flip":
        rng = np.random.default_rng(seed)
        offsets = rng.integers(0, size, size=nbytes)
        with open(path, "r+b") as f:
            for off in offsets:
                f.seek(int(off))
                b = f.read(1)
                f.seek(int(off))
                f.write(bytes([b[0] ^ 0xFF]))
    else:
        raise ValueError(f"unknown mode {mode!r}")
    return path


def stall_step(timer, seconds: float) -> None:
    """Make a ``StepTimer``'s next ``tick()`` observe a ``seconds``-long
    step without sleeping: rewind its last-tick anchor."""
    timer._last -= seconds
