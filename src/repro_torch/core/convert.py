"""Carry parameters and sketch state between the JAX package and the port.

Both directions go through numpy arrays, so this module needs neither JAX
nor ``repro``: the caller turns JAX arrays into numpy (``np.asarray``)
before calling, and back (``jnp.asarray``) after.  The layouts are the
same in both packages — W is (d, P) with P = round_up(K·L, 128), or the
(d, 0) placeholder under the SRHT family, counts are (L, 2^K),
attribution planes (…, 2, NL, R, C) — so nothing is reshaped.  The SRHT's
sign diagonals and row sample need no carrying: both packages draw them
from ``cfg.seed`` with numpy.  The attribution hash tables, which the port
draws with torch as it draws W, carry across with
``attr_tables_from_numpy``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.sketch import AceState


def params_from_numpy(w, device) -> torch.Tensor:
    """The SRP projection matrix W (d, P), or (d, 0) under SRHT, as a
    float32 tensor on ``device``."""
    return torch.as_tensor(np.array(w, np.float32), device=device)


def state_from_numpy(counts, n, welford_mean, welford_m2, device,
                     attr=None) -> AceState:
    """An ``AceState`` on ``device`` from the reference state's leaves
    (``attr``, the (2, NL, R, C) attribution planes, when it has them)."""
    def scalar(v):
        return torch.tensor(float(np.asarray(v, np.float32)),
                            dtype=torch.float32, device=device)
    return AceState(
        counts=torch.as_tensor(np.array(counts), device=device),
        n=scalar(n), welford_mean=scalar(welford_mean),
        welford_m2=scalar(welford_m2),
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
    field name; ``None`` leaves are left out."""
    return {k: v.detach().cpu().numpy() for k, v in zip(state._fields, state)
            if v is not None}


def tree_from_numpy(cls, leaves, device):
    """A port state of NamedTuple type ``cls`` (``WindowedAceState``,
    ``FleetState``, ``WindowedFleetState``, ``AceState``) from the
    reference state's leaves in field order — numpy arrays, or anything
    ``np.array`` takes; a ``None`` leaf stays ``None``."""
    return cls(*(None if x is None
                 else torch.as_tensor(np.array(x), device=device)
                 for x in leaves))
