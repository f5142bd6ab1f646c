"""Carry parameters and sketch state between the JAX package and the port.

Both directions go through numpy arrays, so this module needs neither JAX
nor ``repro``: the caller turns JAX arrays into numpy (``np.asarray``)
before calling, and back (``jnp.asarray``) after.  The layouts are the
same in both packages — W is (d, P) with P = round_up(K·L, 128), or the
(d, 0) placeholder under the SRHT family, counts are (L, 2^K),
quantile histograms (…, NUM_BINS), attribution planes (…, 2, NL, R, C) —
so nothing is reshaped.  Counts keep their dtype (int32, int16, int8 or
float32), and a quantized state's escalation table (``esc``: offs, vals,
lost) comes across whole, promoted slots included.  The SRHT's
sign diagonals and row sample need no carrying: both packages draw them
from ``cfg.seed`` with numpy.  The attribution hash tables, which the port
draws with torch as it draws W, carry across with
``attr_tables_from_numpy``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.quantize import EscTable
from repro_torch.core.sketch import AceState


def params_from_numpy(w, device) -> torch.Tensor:
    """The SRP projection matrix W (d, P), or (d, 0) under SRHT, as a
    float32 tensor on ``device``."""
    return torch.as_tensor(np.array(w, np.float32), device=device)


def esc_from_numpy(esc, device) -> EscTable:
    """The port's ``EscTable`` from the reference's (or any (offs, vals,
    lost) triple of arrays)."""
    offs, vals, lost = esc
    return EscTable(
        offs=torch.as_tensor(np.array(offs, np.int32), device=device),
        vals=torch.as_tensor(np.array(vals, np.int32), device=device),
        lost=torch.as_tensor(np.array(lost, np.float32), device=device))


def state_from_numpy(counts, n, welford_mean, welford_m2, device,
                     attr=None, qhist=None, esc=None) -> AceState:
    """An ``AceState`` on ``device`` from the reference state's leaves
    (``attr``, the (2, NL, R, C) attribution planes, ``qhist``, the
    (NUM_BINS,) rate histogram, and ``esc``, the escalation table, when it
    has them).  The counts keep their dtype."""
    def scalar(v):
        return torch.tensor(float(np.asarray(v, np.float32)),
                            dtype=torch.float32, device=device)
    return AceState(
        counts=torch.as_tensor(np.array(counts), device=device),
        n=scalar(n), welford_mean=scalar(welford_mean),
        welford_m2=scalar(welford_m2),
        esc=None if esc is None else esc_from_numpy(esc, device),
        qhist=None if qhist is None
        else torch.as_tensor(np.array(qhist, np.float32), device=device),
        attr=None if attr is None
        else torch.as_tensor(np.array(attr, np.float32), device=device))


def attr_tables_from_numpy(cols, signs, cfg, device):
    """The port's ``AttrTables`` for ``cfg`` (an ``AttrConfig``) on
    ``device`` from the reference's node tables: ``cols`` (NL, 2^NL, R)
    int32 and ``signs`` (NL, 2^NL, R) float32, e.g.
    ``repro.attribution.sketch._level_tables_np(cfg)``.  Pass them to a
    filter as ``attr_tables=`` to run both packages on the same hash."""
    from repro_torch.attribution.sketch import make_tables
    return make_tables(cfg, device, np.asarray(cols), np.asarray(signs))


def params_to_numpy(w: torch.Tensor) -> np.ndarray:
    return w.detach().cpu().numpy()


def state_to_numpy(state) -> dict[str, np.ndarray]:
    """Any port state's leaves (``AceState``, ``WindowedAceState``,
    ``FleetState``, ``WindowedFleetState``) as numpy arrays, keyed by
    field name (an escalation table's as ``esc.offs``, ``esc.vals`` and
    ``esc.lost``); ``None`` leaves are left out."""
    out = {}
    for k, v in zip(state._fields, state):
        if isinstance(v, EscTable):
            out.update({f"{k}.{f}": x.detach().cpu().numpy()
                        for f, x in zip(v._fields, v)})
        elif v is not None:
            out[k] = v.detach().cpu().numpy()
    return out


def tree_from_numpy(cls, leaves, device):
    """A port state of NamedTuple type ``cls`` (``WindowedAceState``,
    ``FleetState``, ``WindowedFleetState``, ``AceState``) from the
    reference state's leaves in field order — numpy arrays, or anything
    ``np.array`` takes; a ``None`` leaf stays ``None`` and an escalation
    table (the reference's, or an (offs, vals, lost) tuple) becomes an
    ``EscTable``."""
    return cls(*(None if x is None
                 else esc_from_numpy(x, device) if isinstance(x, tuple)
                 else torch.as_tensor(np.array(x), device=device)
                 for x in leaves))
