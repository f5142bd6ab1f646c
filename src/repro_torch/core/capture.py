"""Compile once: one captured CUDA graph per input signature, replayed from
static buffers — the port's counterpart of ``jax.jit(fn,
donate_argnums=0)`` (port-only, like ``core.convert``).

A ``Program`` wraps ``fn(state, *inputs) -> (new_state, outputs)``, where
``state`` is a tree (NamedTuples, tuples, None) of tensors that the call
consumes, as a donated argument, and ``inputs`` are tensors (or None) that
it only reads.  Its key is the flavour flags of the call, the tree and the
shapes and dtypes of the state's leaves and of the inputs; a None operand
and a tensor give different keys, so a degraded call (a health mask
given) is one more program, as in the reference.  ``trace_count`` grows by
one for each key built.

* The first call of a key runs ``fn`` eagerly on the caller's state: the
  warm-up, which fills every cache the path keeps (constant tables, the
  card's cluster table, shared-memory opt-ins) outside any capture.  Its
  new state becomes the key's static state buffers (a leaf that is still
  one of the caller's tensors is cloned first, so the buffers belong to
  the program alone) and copies of its inputs its static inputs.  Then
  ``fn`` is captured once on those buffers into a ``torch.cuda.CUDAGraph``
  whose last nodes ``copy_`` each new state leaf into its static buffer
  wherever the storage differs (the kernels update counts in place; n,
  the Welford leaves and the plain paths' scatters make new tensors).  A
  capture records and runs nothing, so the warm-up's insert is not made
  twice.
* A later call copies in every state leaf that is not the static buffer
  (compared by ``data_ptr``: a state a caller assigned, a repair, a
  checkpoint restore) and every input (an input named in ``consts`` only
  when another tensor, or the same one changed, comes in; one named in
  ``borrowed`` is adopted as the static buffer at the first call, for a
  caller that fills it in place), replays the graph and adds the launches
  its capture recorded to each kernel's ``launches``.
* Every call returns the static state buffers: the state passed in is dead
  after the call, as under ``donate_argnums=0``.  A replay's outputs are
  clones (the graph's own are overwritten by the next replay).

The graphs of one program share one memory pool.  On the CPU, and with
``capture=False`` (a sharded run, whose collectives stage through the
host), keys, counting, static buffers and copy-in/copy-out all run and
only the capture and the replay are skipped: each call runs ``fn`` on the
static buffers.  On the card a capture that fails raises, naming the last
op it reached; nothing falls back to the eager path.  ``disabled()`` runs
``fn`` eagerly on the caller's state, the counterpart of
``jax.disable_jit()`` (no key, no count).
"""
from __future__ import annotations

import contextlib
import gc
import threading
import weakref

import torch
from torch.overrides import TorchFunctionMode

from repro_torch.kernels import build

_off = threading.local()


@contextlib.contextmanager
def disabled():
    """Within it every ``Program`` runs its function eagerly on the
    caller's state: the eager twin of a captured path."""
    before = getattr(_off, "on", False)
    _off.on = True
    try:
        yield
    finally:
        _off.on = before


def is_disabled() -> bool:
    return getattr(_off, "on", False)


def signature(tree):
    """The hashable shape of a tree: its types, None leaves, each tensor's
    shape and dtype, and any other leaf's value."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tuple(tree.shape), tree.dtype
    if isinstance(tree, (tuple, list)):
        return type(tree), tuple(signature(x) for x in tree)
    return type(tree), tree


def leaves(tree) -> list:
    """The tensor (or None) leaves of a tree, in order."""
    if tree is None or isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in leaves(t)]
    return []


def tree_map(fn, tree):
    """``fn`` applied to each tensor of a tree, the rest kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, x) for x in tree)
    return tree


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.numel() == 0 or (a.data_ptr() == b.data_ptr()
                              and a.stride() == b.stride())


def _copy_into(static, new) -> None:
    """``copy_`` each leaf of ``new`` into the static leaf beside it,
    wherever the two differ in storage."""
    for s, x in zip(leaves(static), leaves(new)):
        if s is not None and not _same(s, x):
            s.copy_(x)


def _copy_from(dst: torch.Tensor, src: torch.Tensor) -> None:
    """An input into its static buffer: from pinned host memory without a
    wait (stream-ordered before the replay that reads it)."""
    pinned = src.device.type == "cpu" and dst.device.type == "cuda" \
        and src.is_pinned()
    dst.copy_(src, non_blocking=pinned)


class _LastOp(TorchFunctionMode):
    """Remembers the last PyTorch function a capture called, to name it
    when the capture fails."""

    def __init__(self):
        super().__init__()
        self.name = "(before the first op)"

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.name = getattr(func, "__qualname__", None) or repr(func)
        return func(*args, **(kwargs or {}))


class _Entry:
    __slots__ = ("state", "inputs", "sources", "graph", "out", "tally")

    def __init__(self, state, inputs):
        self.state, self.inputs = state, inputs
        self.sources = [None] * len(inputs)   # consts: (ptr, version)
        self.graph = self.out = None
        self.tally = {}


class Program:
    """One captured graph per key of ``fn(state, *inputs)`` (module
    docstring); ``trace_count`` keys built so far."""

    def __init__(self, fn, device, *, name: str, capture: bool = True,
                 consts: tuple = ()):
        # a method is held weakly, so its owner (which holds the program)
        # is freed, graphs and pool with it, as soon as it is dropped
        self._fn = weakref.WeakMethod(fn) if hasattr(fn, "__self__") \
            else (lambda: fn)
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.name = name
        self.capture = capture and self.device.type == "cuda"
        self.consts = frozenset(consts)
        self.trace_count = 0
        self._entries: dict = {}
        self._last = None             # the entry of the latest call
        self._pool = None

    @property
    def fn(self):
        return self._fn()

    def _on_device(self, x):
        if x is None or x.device == self.device:
            return x
        out = torch.empty_like(x, device=self.device)
        _copy_from(out, x)
        return out

    def __call__(self, state, *inputs, flags=(), borrowed=()):
        """(static new state, outputs) of ``fn`` on this call's operands.
        ``flags`` are the flavour's hashable switches; ``borrowed`` the
        indices of inputs whose tensors the caller owns and refills in
        place, adopted as the static buffers."""
        if is_disabled():
            return self.fn(state, *map(self._on_device, inputs))
        key = (flags, signature(state), tuple(map(signature, inputs)))
        entry = self._entries.get(key)
        if entry is None:
            self.trace_count += 1
            return self._build(key, state, inputs, borrowed)
        self._last = entry
        for s, x in zip(leaves(entry.state), leaves(state)):
            if s is not None and not _same(s, x):
                s.copy_(x)
        for i, (s, x) in enumerate(zip(entry.inputs, inputs)):
            if s is None or _same(s, x):
                continue
            if i in self.consts:
                src = (x.data_ptr(), x._version)
                if entry.sources[i] == src:
                    continue
                entry.sources[i] = src
            _copy_from(s, x)
        if entry.graph is None:
            new, out = self.fn(entry.state, *entry.inputs)
            _copy_into(entry.state, new)
        else:
            entry.graph.replay()
            build.add_launches(entry.tally)
            out = tree_map(torch.clone, entry.out)
        return entry.state, out

    def _build(self, key, state, inputs, borrowed):
        moved = [self._on_device(x) for x in inputs]
        new, out = self.fn(state, *moved)             # the warm-up
        if signature(new) != signature(state):
            raise TypeError(f"{self.name}: the call changed its state's "
                            f"signature ({signature(state)} -> "
                            f"{signature(new)}); a program keeps one")
        # the static state: the new leaves, each the program's own
        taken = {x.data_ptr() for x in leaves(state) + moved
                 if x is not None and x.numel()}

        def own(x):
            if x.numel() and x.data_ptr() in taken:
                x = x.clone()
            taken.add(x.data_ptr())
            return x
        entry = _Entry(tree_map(own, new), [
            x if x is None or i in borrowed or x is not orig else x.clone()
            for i, (x, orig) in enumerate(zip(moved, inputs))])
        for i in self.consts:
            if inputs[i] is not None:
                entry.sources[i] = (inputs[i].data_ptr(), inputs[i]._version)
        if self.capture:
            self._capture(entry)
        self._entries[key] = self._last = entry
        return entry.state, out

    def _capture(self, entry: _Entry) -> None:
        """Record ``fn`` on the entry's static buffers, its copy-out
        appended.  The capture's own device-wide synchronise (and the
        allocator's cache flush) run outside the caller's sync-debug mode:
        they belong to the build, as a trace's compile does."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        mode = torch.cuda.get_sync_debug_mode()
        last = _LastOp()
        torch.cuda.set_sync_debug_mode(0)
        # no collection inside the capture: one that frees another
        # program's graph would call into CUDA and void this capture
        collecting = gc.isenabled()
        gc.disable()
        try:
            with build.tally_launches() as tally, \
                    torch.cuda.graph(graph, pool=self._pool):
                with last:
                    new, out = self.fn(entry.state, *entry.inputs)
                    _copy_into(entry.state, new)
        except Exception as err:
            raise RuntimeError(
                f"{self.name}: CUDA graph capture failed at {last.name}: "
                f"{err}") from err
        finally:
            if collecting:
                gc.enable()
            torch.cuda.set_sync_debug_mode(mode)
        entry.graph, entry.out, entry.tally = graph, out, tally
