"""CRC-checked checkpoints of state trees — port of
``repro.train.checkpoint``, in the same on-disk format, so either package
restores what the other saved.

* A checkpoint is a directory ``step_{step:010d}`` holding ``arrays.npz``
  (leaf i as ``a{i}``) and ``manifest.json`` (``step``, the leaf
  ``names``, ``time``, ``extra`` and one CRC32 per leaf in
  ``checksums``).
* Leaves are tensors, named as the reference's JAX paths name them: a
  NamedTuple field ``.name``, a dict key (keys sorted), a sequence
  index, joined with ``/``; ``None`` is no leaf.  An ``AceState`` or
  ``FleetState`` without optional leaves is ``['.counts', '.n',
  '.welford_mean', '.welford_m2']`` in both packages.
* Writes are atomic (a temporary directory, then a rename); ``keep``
  bounds the steps on disk; steps are found by scanning the directory
  and sorted by number.
* ``restore`` verifies every leaf's CRC32 against the manifest and raises
  ``CheckpointCorruptError`` on a mismatch or an unreadable npz (a
  manifest without checksums verifies as intact), and
  ``CheckpointManager.restore_latest`` falls back to the newest intact
  step.
* ``restore`` places each leaf on the device and in the dtype of the
  matching leaf of ``like_tree``; with ``specs`` and a ``mesh`` (the
  counterpart of the reference's ``shardings=``) each leaf is cut to this
  rank's block (``dist.mesh.local_block``), whatever world size saved
  it: a checkpoint always holds whole leaves.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import tempfile
import time
import zipfile
import zlib

import numpy as np
import torch


class CheckpointCorruptError(RuntimeError):
    """A checkpoint failed integrity verification (bad CRC, torn npz,
    missing leaf).  ``CheckpointManager.restore_latest`` catches this and
    falls back to the next-newest intact step."""


def _leaf_crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes())


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _flatten_with_names(tree):
    """(names, leaves) of a tree of NamedTuples, dicts, lists and tuples,
    in the reference's order and naming."""
    names, leaves = [], []

    def walk(node, path):
        if node is None:
            return
        if _is_namedtuple(node):
            for f, v in zip(node._fields, node):
                walk(v, path + [f".{f}"])
        elif isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + [str(k)])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + [str(i)])
        else:
            names.append("/".join(path))
            leaves.append(node)
    walk(tree, [])
    return names, leaves


def _unflatten(like, leaves):
    """A tree shaped as ``like`` with its leaves taken from ``leaves`` (an
    iterator) in ``_flatten_with_names``' order."""
    if like is None:
        return None
    if _is_namedtuple(like):
        return type(like)(*(_unflatten(v, leaves) for v in like))
    if isinstance(like, dict):
        out = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: out[k] for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


def save(ckpt_dir: str, step: int, tree, extra: dict | None = None,
         keep: int = 3) -> str:
    """Atomic checkpoint write.  Returns the checkpoint path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    names, leaves = _flatten_with_names(tree)
    arrays = {f"a{i}": leaf.detach().cpu().numpy()
              for i, leaf in enumerate(leaves)}
    manifest = {
        "step": int(step),
        "names": names,
        "time": time.time(),
        "extra": extra or {},
        "checksums": [_leaf_crc(arrays[f"a{i}"])
                      for i in range(len(leaves))],
    }
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    try:
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: str, keep: int) -> None:
    if keep <= 0:
        return
    keep_names = {name for _, name in _step_dirs(ckpt_dir)[-keep:]}
    for name in os.listdir(ckpt_dir):
        if (re.fullmatch(r"step_(\d+)", name)
                and name not in keep_names
                and os.path.exists(os.path.join(ckpt_dir, name,
                                                "manifest.json"))):
            shutil.rmtree(os.path.join(ckpt_dir, name), ignore_errors=True)


def _step_dirs(ckpt_dir: str) -> list[tuple[int, str]]:
    """(step, dirname) pairs sorted by step number, not by name, so an
    unpadded ``step_9`` is a checkpoint like any other and sorts before
    ``step_10``; where one step has both a padded and an unpadded
    directory the padded one wins."""
    if not os.path.isdir(ckpt_dir):
        return []
    found: dict[int, str] = {}
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", name)
        if not (m and os.path.exists(os.path.join(ckpt_dir, name,
                                                  "manifest.json"))):
            continue
        step = int(m.group(1))
        prev = found.get(step)
        if prev is None or name == f"step_{step:010d}":
            found[step] = name
    return sorted(found.items())


def _resolve_step_dir(ckpt_dir: str, step: int) -> str:
    canonical = os.path.join(ckpt_dir, f"step_{step:010d}")
    if os.path.exists(os.path.join(canonical, "manifest.json")):
        return canonical
    for s, name in _step_dirs(ckpt_dir):
        if s == step:
            return os.path.join(ckpt_dir, name)
    return canonical   # restore() raises its usual error


def all_steps(ckpt_dir: str) -> list[int]:
    return [s for s, _ in _step_dirs(ckpt_dir)]


def latest_step(ckpt_dir: str) -> int | None:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def _spec_leaves(like, specs) -> list:
    """The spec of each leaf of ``like``, in ``_flatten_with_names``'
    order, from ``specs``, a tree of ``like``'s structure with a
    ``PartitionSpec`` at each tensor."""
    out = []

    def walk(node, spec):
        if node is None:
            return
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], spec[k])
        elif isinstance(node, (list, tuple)):
            for v, sp in zip(node, spec):
                walk(v, sp)
        else:
            out.append(spec)
    walk(like, specs)
    return out


def restore(ckpt_dir: str, step: int, like_tree, specs=None, mesh=None):
    """Load a checkpoint into the structure of ``like_tree``; each leaf
    takes the dtype and device of its ``like_tree`` leaf.  Returns
    ``(tree, manifest)``.

    With ``specs`` (a ``PartitionSpec`` at each tensor of ``like_tree``'s
    structure) and a live ``mesh``,
    ``like_tree`` holds this rank's blocks and so does the result: each
    whole leaf of the checkpoint is cut to its block under its spec.

    Raises ``CheckpointCorruptError`` when the npz is torn or unreadable
    or any leaf's CRC32 disagrees with the manifest (a manifest without
    checksums skips verification), ``ValueError`` when the tree's leaf
    names or shapes differ from the checkpoint's.
    """
    path = _resolve_step_dir(ckpt_dir, step)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    try:
        with np.load(os.path.join(path, "arrays.npz")) as z:
            arrays = [z[f"a{i}"] for i in range(len(manifest["names"]))]
    except (OSError, ValueError, KeyError, EOFError,
            zipfile.BadZipFile) as e:
        raise CheckpointCorruptError(
            f"step {step}: unreadable arrays.npz ({e})") from e
    checksums = manifest.get("checksums")
    if checksums is not None:
        for i, (arr, want) in enumerate(zip(arrays, checksums)):
            got = _leaf_crc(arr)
            if got != want:
                raise CheckpointCorruptError(
                    f"step {step}: leaf a{i} ({manifest['names'][i]}) "
                    f"CRC mismatch (manifest {want:#010x}, "
                    f"file {got:#010x})")
    names, like_leaves = _flatten_with_names(like_tree)
    if names != manifest["names"]:
        raise ValueError("checkpoint tree mismatch: "
                         f"{set(names) ^ set(manifest['names'])}")
    per_leaf = (_spec_leaves(like_tree, specs) if mesh is not None
                else [None] * len(like_leaves))
    leaves = []
    for arr, like, ps in zip(arrays, like_leaves, per_leaf):
        whole = torch.from_numpy(np.array(arr))
        if ps is not None:
            from repro_torch.dist.mesh import local_block, local_shape
            if local_shape(arr.shape, ps, mesh) != tuple(like.shape):
                raise ValueError(f"shape mismatch: {arr.shape} under {ps} "
                                 f"is not the block {tuple(like.shape)}")
            whole = local_block(whole, ps, mesh)
        elif tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"shape mismatch {arr.shape} vs "
                             f"{tuple(like.shape)}")
        leaves.append(whole.to(device=like.device, dtype=like.dtype))
    return _unflatten(like_tree, iter(leaves)), manifest


@dataclasses.dataclass
class CheckpointManager:
    """Step-driven wrapper: save every ``interval`` steps, keep ``keep``."""
    ckpt_dir: str
    interval: int = 100
    keep: int = 3

    def maybe_save(self, step: int, tree, extra=None) -> str | None:
        if step % self.interval != 0:
            return None
        return save(self.ckpt_dir, step, tree, extra=extra, keep=self.keep)

    def restore_latest(self, like_tree, specs=None, mesh=None):
        """Restore the newest intact checkpoint (onto ``mesh``'s blocks by
        ``specs``, as ``restore``): steps are tried newest first, and one
        that fails verification (``CheckpointCorruptError``) is skipped.
        Returns ``(None, None)`` when none is intact."""
        for step in reversed(all_steps(self.ckpt_dir)):
            try:
                return restore(self.ckpt_dir, step, like_tree, specs, mesh)
            except CheckpointCorruptError:
                continue
        return None, None
