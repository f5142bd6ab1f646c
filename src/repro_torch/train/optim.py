"""Optimisers written out in plain PyTorch — port of ``repro.train.optim``.

All optimisers share the reference's contract:
    state = opt.init(params)
    new_params, new_state = opt.update(params, grads, state, step, lr)

with ``step`` the step counter (a tensor on the parameters' device) and
``lr`` a float32 tensor or a float.  Master weights stay in the params'
own dtype (float32 recommended); moments are float32.

Unlike the reference, whose update returns new arrays, ``update`` writes
each new parameter and moment into the tensor it replaces, one leaf at a
time, and returns the trees it was given: the transient memory of an
update is one leaf, never a second copy of the model (4.7 GB at
olmo_1b's 1,176,764,416 parameters).  ``skip`` (a bool 0-d tensor) keeps
every old value where it is true, with no host sync: the gradient
monitor's skip of an anomalous step, the reference's
``jnp.where(is_anom, old, new)`` over params and state.

The reference works per leaf of its tree, whose layer leaves are stacked
over the superblocks.  Sgd and AdamW are elementwise, so per tensor is the
same; Adafactor's factored moments and its update clip are not, so it
walks ``models.convert.reference_leaves`` and works on each stacked leaf
as the reference does (its moments are held in that layout).

Implemented: SGD (+momentum, Nesterov), AdamW (decoupled decay), Adafactor
(factored second moments for leaves of rank >= 2).  ``state_pspecs``
gives the state's ``repro_torch.dist.mesh.PartitionSpec`` tree from the
parameters', as the reference's does.  Under a mesh (``train.sharded``)
Sgd and AdamW update a rank's blocks leaf by leaf as they update whole
tensors; Adafactor's ``update(mesh=, specs=)`` all-reduces each
whole-leaf statistic over the axes that split it.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.dist import collectives as col
from repro_torch.dist.mesh import P, axis_sizes, split_axes
from repro_torch.models.convert import reference_leaves
from repro_torch.models.registry import leaves, tree_map
from repro_torch.train.schedule import scalar_div

F32 = torch.float32


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of the float32 sum of squares (each
    leaf's norm in one ``_foreach_norm``, the sum of their squares, its
    square root)."""
    norms = torch._foreach_norm([x.to(F32) for x in leaves(tree)])
    return torch.sqrt(torch.sum(torch.stack(norms) ** 2))


def clip_by_global_norm(grads, max_norm: float):
    """(grads × min(1, max_norm / (norm + 1e-9)) in float32, norm)."""
    norm = global_norm(grads)
    scale = torch.clamp_max(torch.full_like(norm, max_norm) / (norm + 1e-9),
                            1.0)
    return tree_map(lambda g: g.to(F32) * scale, grads), norm


def _write(dst: torch.Tensor, new: torch.Tensor, skip) -> None:
    """dst <- new (or dst where ``skip``), in place."""
    with torch.no_grad():
        dst.copy_(new if skip is None else torch.where(skip, dst, new))


def _t32(step) -> torch.Tensor:
    return (step.to(F32) if isinstance(step, torch.Tensor)
            else torch.tensor(float(step), dtype=F32))


# ---------------------------------------------------------------------------
# SGD
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Sgd:
    momentum: float = 0.9
    nesterov: bool = False

    def init(self, params):
        if self.momentum == 0.0:
            return {}
        return {"m": tree_map(lambda p: torch.zeros(p.shape, dtype=F32,
                                                     device=p.device),
                              params)}

    def state_pspecs(self, param_pspecs):
        """The state's specs, given the parameters'."""
        return {} if self.momentum == 0.0 else {"m": param_pspecs}

    def update(self, params, grads, state, step, lr, skip=None):
        del step
        ms = list(leaves(state["m"])) if self.momentum != 0.0 else None
        for i, (p, g) in enumerate(zip(leaves(params), leaves(grads))):
            g = g.to(F32)
            if ms is None:
                u = g
            else:
                m = self.momentum * ms[i] + g
                u = self.momentum * m + g if self.nesterov else m
                _write(ms[i], m, skip)
            _write(p, (p.to(F32) - lr * u).to(p.dtype), skip)
        return params, state


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AdamW:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1

    def init(self, params):
        def z(p):
            return torch.zeros(p.shape, dtype=F32, device=p.device)
        return {"m": tree_map(z, params), "v": tree_map(z, params)}

    def state_pspecs(self, param_pspecs):
        """The state's specs, given the parameters'."""
        return {"m": param_pspecs, "v": param_pspecs}

    def update(self, params, grads, state, step, lr, skip=None):
        # b ** t in float32 on the step's device, as jnp computes it
        t = _t32(step) + 1.0
        c1 = 1.0 - self.b1 ** t
        c2 = 1.0 - self.b2 ** t
        for p, g, m, v in zip(leaves(params), leaves(grads),
                              leaves(state["m"]), leaves(state["v"])):
            g = g.to(F32)
            m_new = self.b1 * m + (1 - self.b1) * g
            v_new = self.b2 * v + (1 - self.b2) * g * g
            mhat = m_new / c1
            vhat = v_new / c2
            p32 = p.to(F32)
            upd = mhat / (torch.sqrt(vhat) + self.eps) \
                + self.weight_decay * p32
            _write(m, m_new, skip)
            _write(v, v_new, skip)
            _write(p, (p32 - lr * upd).to(p.dtype), skip)
            del m_new, v_new, mhat, vhat, upd
        return params, state


# ---------------------------------------------------------------------------
# Adafactor (Shazeer & Stern) — factored second moment, no first moment.
# ---------------------------------------------------------------------------

def _stacked(leaf) -> torch.Tensor:
    """A reference leaf as one tensor (a copy when stacked)."""
    return torch.stack(leaf.parts) if leaf.stacked else leaf.parts[0]


def _shape(leaf) -> tuple:
    return (((len(leaf.parts),) if leaf.stacked else ())
            + tuple(leaf.parts[0].shape))


@dataclasses.dataclass(frozen=True)
class Adafactor:
    decay_pow: float = 0.8        # beta2_t = 1 - t^-0.8
    eps: float = 1e-30
    clip_threshold: float = 1.0
    weight_decay: float = 0.0

    def _factored(self, shape) -> bool:
        return len(shape) >= 2

    def init(self, params):
        """``{"slots": [...]}``, one slot a leaf of ``reference_leaves``
        in the reference's (stacked) layout: ``vr``/``vc`` for rank >= 2,
        ``v`` otherwise."""
        slots = []
        for leaf in reference_leaves(params):
            shape, dev = _shape(leaf), leaf.parts[0].device
            if self._factored(shape):
                slots.append({
                    "vr": torch.zeros(shape[:-1], dtype=F32, device=dev),
                    "vc": torch.zeros(shape[:-2] + shape[-1:], dtype=F32,
                                      device=dev)})
            else:
                slots.append({"v": torch.zeros(shape, dtype=F32,
                                               device=dev)})
        return {"slots": slots}

    def state_pspecs(self, param_pspecs):
        """The slots' specs, one a reference leaf: a stacked leaf's spec
        gains the reference's leading (unsplit) layers entry; ``vr`` drops
        the last entry, ``vc`` the second to last, ``v`` keeps them all
        (every key, as the reference gives them)."""
        def per_leaf(leaf):
            entries = ((None,) if leaf.stacked else ()) + tuple(leaf.parts[0])
            return {"vr": P(*entries[:-1]),
                    "vc": P(*(entries[:-2] + entries[-1:]))
                    if len(entries) >= 2 else P(),
                    "v": P(*entries)}
        return {"slots": [per_leaf(leaf)
                          for leaf in reference_leaves(param_pspecs)]}

    def update(self, params, grads, state, step, lr, skip=None, *,
               mesh=None, specs=None):
        """One step.  Under a ``mesh`` the trees hold this rank's blocks
        of the leaves, laid out by ``specs`` (the parameters' spec tree),
        and each whole-leaf statistic is all-reduced over the axes that
        split the dims it reduces: the factored row and column means and
        the mean of ``vr`` (their partial means summed, ÷ the number of
        blocks), and the update clip's Σu² with its element count.  An
        unsplit leaf takes no collective and the single card's sums."""
        t = _t32(step) + 1.0
        beta2 = 1.0 - t ** (-self.decay_pow)
        refs = (reference_leaves(specs) if mesh is not None
                else [None] * len(state["slots"]))
        for pl, gl, slot, sl in zip(reference_leaves(params),
                                    reference_leaves(grads), state["slots"],
                                    refs):
            p, g = _stacked(pl), _stacked(gl).to(F32)
            split = split_dims(sl, p.dim(), mesh)
            g2 = g * g + self.eps
            if self._factored(p.shape):
                vr = beta2 * slot["vr"] + (1 - beta2) * _mean(
                    g2, -1, split[-1], mesh)
                vc = beta2 * slot["vc"] + (1 - beta2) * _mean(
                    g2, -2, split[-2], mesh)
                denom = torch.sqrt(
                    vr[..., :, None] * vc[..., None, :]
                    / (_mean(vr, -1, split[-2], mesh, keepdim=True)
                       [..., None] + 1e-30))
                u = g / (denom + 1e-30)
                new_slot = {"vr": vr, "vc": vc}
            else:
                v = beta2 * slot["v"] + (1 - beta2) * g2
                u = g / (torch.sqrt(v) + 1e-30)
                new_slot = {"v": v}
            # update clipping (RMS <= threshold)
            every = leaf_axes(sl, mesh) if sl is not None else ()
            if every:
                # Σu² and the element count over every block of the leaf
                tot = col.all_reduce(torch.stack(
                    [torch.sum(u * u).to(torch.float64),
                     torch.tensor(float(u.numel()), dtype=torch.float64,
                                  device=u.device)]), mesh, every)
                ms = (tot[0] / tot[1]).to(F32)
            else:
                ms = torch.mean(u * u)
            rms = torch.sqrt(ms + 1e-30)
            u = u / torch.clamp_min(scalar_div(rms, self.clip_threshold),
                                    1.0)
            p32 = p.to(F32)
            if self.weight_decay:
                u = u + self.weight_decay * p32
            new_p = (p32 - lr * u).to(p.dtype)
            for k, v in new_slot.items():
                _write(slot[k], v, skip)
            if pl.stacked:
                for r, part in enumerate(pl.parts):
                    _write(part, new_p[r], skip)
            else:
                _write(pl.parts[0], new_p, skip)
        return params, state


def split_dims(ref_spec, rank: int, mesh) -> list:
    """Per dim of a reference leaf of ``rank`` dims, the mesh axes of more
    than one rank that split it (none off a mesh): its parts' spec behind
    the stacked leaf's unsplit leading entry."""
    if ref_spec is None:
        return [()] * rank
    entries = P(*(((None,) if ref_spec.stacked else ())
                  + tuple(ref_spec.parts[0])))
    return [split_axes(entries, d, mesh) for d in range(rank)]


def leaf_axes(ref_spec, mesh) -> tuple:
    """Every axis of more than one rank that splits a reference leaf."""
    ps = ref_spec.parts[0]
    return tuple(dict.fromkeys(a for d in range(len(ps))
                               for a in split_axes(ps, d, mesh)))


def _mean(x: torch.Tensor, dim: int, axes: tuple, mesh,
          keepdim: bool = False) -> torch.Tensor:
    """The mean over dim ``dim`` of the whole leaf of block ``x``: the
    block's mean, and where ``axes`` split that dim the blocks' means
    summed over them ÷ their count (equal blocks)."""
    m = torch.mean(x, dim, keepdim=keepdim)
    if not axes:
        return m
    sizes = axis_sizes(mesh)
    return scalar_div(col.all_reduce(m, mesh, axes),
                      math.prod(sizes[a] for a in axes))


def make_optimizer(name: str, **kw):
    return {"sgd": Sgd, "adamw": AdamW, "adafactor": Adafactor}[name](**kw)


def optimizer_memory_bytes(name: str, param_count: int,
                           param_bytes: int = 4) -> int:
    """Analytic optimizer-state footprint (the reference's capacity
    planning numbers)."""
    per = {"sgd": 4, "adamw": 8, "adafactor": 0.1}[name]
    return int(param_count * (param_bytes + per))
