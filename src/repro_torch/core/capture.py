"""Compile once: one captured CUDA graph per input signature, replayed from
static buffers — the port's counterpart of ``jax.jit(fn,
donate_argnums=0)`` (port-only, like ``core.convert``).

A ``Program`` wraps ``fn(state, *inputs) -> (new_state, outputs)``, where
``state`` is a tree (dicts, lists, tuples, NamedTuples, None) of tensors
that the call consumes, as a donated argument, and ``inputs`` are trees
(or single tensors, or None) that it only reads.  Its key is the flavour
flags of the call, the tree and the shapes and dtypes of the state's
leaves and of the inputs' leaves (a dict's keys sorted, as jit's pytrees
sort them); a None operand and a tensor give different keys, so a
degraded call (a health mask given) is one more program, as in the
reference.  ``trace_count`` grows by one for each key built.

* The first call of a key builds it.  Its inputs become the key's static
  inputs: a leaf on the program's device is cloned, one on the host
  copied over (so the buffers belong to the program alone), but an input
  named in ``adopt`` (the program's, or a call's own) is read where it
  lies, never cloned and never written (a model's weights: a second copy
  of Mixtral's 47 GB would not fit the card; a runner's own staging
  buffer, refilled in place).  Then ``fn`` runs eagerly on the caller's
  state and the static inputs: the warm-up, which fills every cache the
  path keeps (constant tables, the card's cluster table, shared-memory
  opt-ins) outside any capture.  Its new state becomes the key's static
  state buffers (a leaf that is still one of the caller's tensors or an
  input is cloned first; with ``donate=True`` one of the caller's state
  tensors is kept as it is, uncloned: a training step that writes its
  parameters and moments in place owns them from then on, as
  ``donate_argnums=0`` gives jit the caller's buffers).  Then ``fn`` is
  captured once on those buffers into a
  ``torch.cuda.CUDAGraph`` whose last nodes ``copy_`` each new state leaf
  into its static buffer wherever the storage differs (the kernels update
  counts in place; n, the Welford leaves, the plain paths' scatters and a
  model's caches make new tensors, a view of a new tensor among them).
  A capture records and runs nothing, so the warm-up's insert is not made
  twice.
* A later call copies in every state leaf that is not the static buffer
  (compared by ``data_ptr``: a state a caller assigned, a repair, a
  checkpoint restore, a prefill's cache) and every input leaf; a leaf of
  an input named in ``consts`` only when another tensor, or the same one
  changed (its ``_version``), comes in than the last one copied (a const
  is small, a projection, and may come from the host or anew from a
  restore: a copy costs less than a capture).  An
  adopted input is not copied: the graph reads its leaves at the
  addresses it was captured on, so a call whose adopted leaves lie there
  (the same tensors, changed in place or not) replays, and a call whose
  adopted leaves lie elsewhere (new weights of the same shapes), or that
  adopts other inputs than the build did, builds that key again on them
  — a warm-up and a capture that replace the key's graph and drop the
  old one — without counting a program, as jit does not retrace for new
  values.  The program keeps no reference to an adopted tensor, so a
  caller's ``del`` frees it.  Then the graph is replayed and the launches
  its capture recorded are added to each kernel's ``launches``.
* Every call returns the static state buffers: the state passed in is dead
  after the call, as under ``donate_argnums=0``.  A replay's outputs are
  clones (the graph's own are overwritten by the next replay).
* A ``torch.Generator`` in the state (a training state's ``rng``) is keyed
  on its device only, as a key array of jit is on its shape: a restore
  that hands in another generator replays the same program.  The key's
  generator is the one its build was given; a later call that hands in
  another copies that one's state into it, and a capture registers it
  with the graph (``register_generator_state``), so each replay draws
  where the eager call would and advances the generator as it does.

Graphs share one memory pool: a program's own (``Pool``), or one that
several programs of an owner share (``ServeEngine``'s prefill and decode
step), which holds one peak of temporaries instead of one a program.
Sharing is safe in any replay order: the static buffers lie outside the
pool and each replay's outputs are cloned before any other graph runs,
so between replays the pool holds nothing live but the outputs the
graphs keep.  On the CPU, and with ``capture=False`` (a sharded run,
whose collectives stage through the host), keys, counting, static
buffers and copy-in/copy-out all run and only the capture and the replay
are skipped: each call runs ``fn`` on the static buffers (and on the
adopted inputs it was given).  On the card a
capture that fails raises, naming the last op it reached; nothing falls
back to the eager path.  ``disabled()`` runs ``fn`` eagerly on the
caller's state, the counterpart of ``jax.disable_jit()`` (no key, no
count).
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


def _walk(tree, out: list):
    """Append the tensor (or None) leaves of ``tree`` to ``out``, in order
    (a dict's by sorted key), and return its structure: the types, a
    dict's keys, which leaves are None and any other leaf's value."""
    if isinstance(tree, torch.Tensor):
        out.append(tree)
        return True
    if tree is None:
        out.append(None)
        return None
    if isinstance(tree, dict):
        keys = sorted(tree)
        return dict, tuple(keys), tuple([_walk(tree[k], out) for k in keys])
    if isinstance(tree, (tuple, list)):
        return type(tree), tuple([_walk(x, out) for x in tree])
    if isinstance(tree, torch.Generator):
        return torch.Generator, tree.device
    return type(tree), tree


def flatten(tree) -> tuple:
    """(signature, leaves) of a tree in one walk: the signature is hashable,
    its structure and each tensor leaf's shape and dtype."""
    out: list = []
    structure = _walk(tree, out)
    return (structure, tuple([None if x is None else (x.shape, x.dtype)
                              for x in out])), out


def signature(tree):
    """The hashable shape of a tree (``flatten``)."""
    return flatten(tree)[0]


def leaves(tree) -> list:
    """The tensor (or None) leaves of a tree, in order (a dict's by sorted
    key)."""
    out: list = []
    _walk(tree, out)
    return out


def generators(tree) -> list:
    """The ``torch.Generator`` leaves of a tree, in ``leaves`` order."""
    if isinstance(tree, torch.Generator):
        return [tree]
    if isinstance(tree, dict):
        return [g for k in sorted(tree) for g in generators(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [g for x in tree for g in generators(x)]
    return []


def tree_map(fn, tree):
    """``fn`` applied to each tensor of a tree, the rest kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
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


def _source(x):
    """What a const leaf was last copied in from: the tensor itself (held
    weakly: a new tensor the allocator puts at a freed one's address is
    another source) and its version."""
    return None if x is None else (weakref.ref(x), x._version)


def _unchanged(source, x) -> bool:
    return source is not None and source[0]() is x \
        and source[1] == x._version


class Pool:
    """One CUDA graph memory pool, made at the first capture; programs
    given the same ``Pool`` capture into it (module docstring)."""

    def __init__(self):
        self._handle = None

    @property
    def handle(self):
        if self._handle is None:
            self._handle = torch.cuda.graph_pool_handle()
        return self._handle


class _LastOp(TorchFunctionMode):
    """Remembers the last PyTorch function a capture called, to name it
    when the capture fails."""

    def __init__(self):
        super().__init__()
        self.name = "(before the first op)"

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.name = getattr(func, "__qualname__", None) or repr(func)
        return func(*args, **(kwargs or {}))


def _where(xs) -> tuple:
    """Where a graph reads an adopted input's leaves: each one's address
    and strides (its shape and dtype are in the key)."""
    return tuple([None if x is None else (x.data_ptr(), x.stride())
                  for x in xs])


class _Entry:
    __slots__ = ("state", "inputs", "state_leaves", "generators",
                 "input_leaves", "adopt", "where", "sources", "graph", "out",
                 "tally")

    def __init__(self, state, inputs, adopt):
        self.state, self.inputs, self.adopt = state, inputs, adopt
        self.state_leaves = leaves(state)
        self.generators = generators(state)
        self.input_leaves = [leaves(x) for x in inputs]
        self.where = [_where(xs) if i in adopt else None
                      for i, xs in enumerate(self.input_leaves)]
        self.sources = [None] * len(inputs)   # consts: each leaf's source
        self.graph = self.out = None
        self.tally = {}

    def let_go(self) -> None:
        """Hold no adopted tensor past the build: the graph reads them by
        address, and an uncaptured call is given them anew."""
        for i in self.adopt:
            self.inputs[i] = self.input_leaves[i] = None


class Program:
    """One captured graph per key of ``fn(state, *inputs)`` (module
    docstring); ``trace_count`` keys built so far."""

    def __init__(self, fn, device, *, name: str, capture: bool = True,
                 consts: tuple = (), adopt: tuple = (), donate: bool = False,
                 pool: Pool | None = None):
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
        self.adopt = frozenset(adopt)   # a call's default
        self.donate = donate
        self.trace_count = 0
        self._entries: dict = {}
        self._last = None             # the entry of the latest call
        self._pool = pool or Pool()

    @property
    def fn(self):
        return self._fn()

    def _on_device(self, x):
        if x.device == self.device:
            return x
        out = torch.empty_like(x, device=self.device)
        _copy_from(out, x)
        return out

    def _staged(self, x):
        """A leaf's static buffer: the program's own copy of it."""
        return x.clone() if x.device == self.device else self._on_device(x)

    def _adopted(self, tree):
        for x in leaves(tree):
            if x is not None and x.device != self.device:
                raise ValueError(f"{self.name}: an adopted input lies on "
                                 f"{x.device}, the program on {self.device}")
        return tree

    def __call__(self, state, *inputs, flags=(), adopt=None):
        """(static new state, outputs) of ``fn`` on this call's operands.
        ``flags`` are the flavour's hashable switches; ``adopt`` the
        indices of inputs read where they lie (module docstring), the
        program's ``adopt`` unless given."""
        if is_disabled():
            return self.fn(state, *(tree_map(self._on_device, x)
                                    for x in inputs))
        adopt = self.adopt if adopt is None else frozenset(adopt)
        sig, given = flatten(state)
        flat = [flatten(x) for x in inputs]
        key = (flags, sig, tuple(f[0] for f in flat))
        entry = self._entries.get(key)
        if entry is None:
            self.trace_count += 1
            return self._build(key, state, inputs, adopt)
        if entry.adopt != adopt or any(entry.where[i] != _where(flat[i][1])
                                       for i in adopt):
            return self._build(key, state, inputs, adopt)   # not counted
        self._last = entry
        for s, x in zip(entry.state_leaves, given):
            if s is not None and s is not x and not _same(s, x):
                s.copy_(x)
        for s, g in zip(entry.generators, generators(state)):
            if s is not g:
                s.set_state(g.get_state())
        for i, (_, given) in enumerate(flat):
            if i in adopt:
                continue
            sources = entry.sources[i]
            for j, (s, x) in enumerate(zip(entry.input_leaves[i], given)):
                if s is None or s is x or _same(s, x):
                    continue
                if sources is not None:
                    if _unchanged(sources[j], x):
                        continue
                    sources[j] = _source(x)
                _copy_from(s, x)
        if entry.graph is None:
            new, out = self.fn(entry.state, *(
                x if i in adopt else s
                for i, (s, x) in enumerate(zip(entry.inputs, inputs))))
            _copy_into(entry.state, new)
        else:
            entry.graph.replay()
            build.add_launches(entry.tally)
            out = tree_map(torch.clone, entry.out)
        return entry.state, out

    def _build(self, key, state, inputs, adopt):
        static = [self._adopted(x) if i in adopt else tree_map(self._staged, x)
                  for i, x in enumerate(inputs)]
        new, out = self.fn(state, *static)            # the warm-up
        if signature(new) != signature(state):
            raise TypeError(f"{self.name}: the call changed its state's "
                            f"signature ({signature(state)} -> "
                            f"{signature(new)}); a program keeps one")
        # the static state: the new leaves, each the program's own (a
        # donated state's tensors are the program's already)
        taken = {x.data_ptr() for x in leaves(static)
                 + ([] if self.donate else leaves(state))
                 if x is not None and x.numel()}

        def own(x):
            if x.numel() and x.data_ptr() in taken:
                x = x.clone()
            taken.add(x.data_ptr())
            return x
        if self._entries.pop(key, None) is self._last:
            self._last = None           # a rebuilt key's old graph goes now
        entry = _Entry(tree_map(own, new), static, adopt)
        for i in self.consts - adopt:
            entry.sources[i] = [_source(x) for x in leaves(inputs[i])]
        if self.capture:
            self._capture(entry)
        entry.let_go()
        self._entries[key] = self._last = entry
        return entry.state, out

    def _capture(self, entry: _Entry) -> None:
        """Record ``fn`` on the entry's static buffers, its copy-out
        appended.  The capture's own device-wide synchronise (and the
        allocator's cache flush) run outside the caller's sync-debug mode:
        they belong to the build, as a trace's compile does."""
        graph = torch.cuda.CUDAGraph()
        for g in entry.generators:
            if g.device.type == "cuda":
                graph.register_generator_state(g)
        mode = torch.cuda.get_sync_debug_mode()
        last = _LastOp()
        torch.cuda.set_sync_debug_mode(0)
        # no collection inside the capture: one that frees another
        # program's graph would call into CUDA and void this capture
        collecting = gc.isenabled()
        gc.disable()
        try:
            with build.tally_launches() as tally, \
                    torch.cuda.graph(graph, pool=self._pool.handle):
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
