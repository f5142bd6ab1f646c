"""Build and bind the port's CUDA kernels (the counterpart of
``repro.kernels.runtime``).

Each ``csrc/<name>.cu`` is compiled on first use by ``nvcc`` into its own
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds, not minutes), under ``build/repro_torch/`` at the root of
the checkout.  A library is cached under a hash of every source in
``csrc/`` and the compiler flags, so an edited kernel rebuilds and an
unchanged one loads at once.  All sources are compiled in parallel, one
``nvcc`` process each.

The libraries are loaded with ``ctypes``: pointers and the stream pass as
``c_void_p``, ints as ``c_int``.  Every C entry point returns
``cudaGetLastError()`` after its launches; ``Kernel.__call__`` raises if it
is not 0 and counts the launch otherwise.

A failed build raises.  Nothing here ever falls back to the plain PyTorch
version: that choice is made by the wrappers, from the device of the
tensors alone.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from repro_torch.core.srp import OPERAND_DTYPES

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_log: dict[str, str] = {}   # source name -> nvcc/ptxas output


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else PyTorch's idea
    of the toolkit's home.  Raises when there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        candidates.append(Path(CUDA_HOME) / "bin" / "nvcc")
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("repro_torch: no nvcc found (set CUDA_HOME or put "
                       "nvcc on PATH); the CUDA kernels cannot be built")


def sources() -> list[str]:
    """Names of the kernel sources: ``csrc/<name>.cu``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest()}.so"


def nvcc_command(nvcc: str, name: str, out: Path) -> list[str]:
    return [nvcc, *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def build_all() -> dict[str, Path]:
    """Compile every source not yet in the cache, all at once, and return
    the library path of each.  Raises with the compiler's output if any
    build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: library_path(name) for name in sources()}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    nvcc = find_nvcc()
    procs = {}
    for name, path in todo.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (tmp, subprocess.Popen(
            nvcc_command(nvcc, name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        build_log[name] = out
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (nvcc exit {proc.returncode})\n"
                          f"{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, todo[name])    # atomic: a cached .so is whole
    if failed:
        raise RuntimeError("repro_torch: kernel build failed\n"
                           + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building every kernel
    source first if the cache lacks it."""
    with _lock:
        if name not in _libs:
            paths = build_all()
            for n, p in paths.items():
                _libs.setdefault(n, ctypes.CDLL(str(p)))
        return _libs[name]


_shapes = threading.local()


@contextlib.contextmanager
def plain_on_meta():
    """Within it, ``meta`` tensors take the plain versions (shapes only:
    nothing is computed and no kernel launches), so a program can run on
    ``meta`` for its shapes, costs and collectives
    (``train.sharded.step_on_meta``).  Outside it a wrapper refuses
    ``meta``."""
    before = getattr(_shapes, "on", False)
    _shapes.on = True
    try:
        yield
    finally:
        _shapes.on = before


def on_cpu(*tensors: torch.Tensor) -> bool:
    """Where a wrapper runs: True when every tensor lies on the CPU (take
    the plain version), or on ``meta`` within ``plain_on_meta``; False when
    all lie on one CUDA device (launch the kernel).  Raises for anything
    else: mixed devices or another backend."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"operands on different devices: {sorted(map(str, devices))}")
    device = devices.pop()
    if device.type == "meta" and getattr(_shapes, "on", False):
        return True
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no repro_torch kernel for device {device}")
    return device.type == "cpu"


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape) -> None:
    """Raise unless ``t`` has the dtype, shape and (row-major) contiguity a
    kernel takes."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: want {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: want shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


# The counter types of the kernels that read or add counters, in the order
# of their codes (csrc/common.cuh CountCode): the reference's count dtypes.
COUNT_DTYPES = (torch.int32, torch.int16, torch.int8, torch.float32)


def check_counts(t: torch.Tensor, name: str, shape) -> None:
    """``check`` for a count plane of any of ``COUNT_DTYPES``.  On the card
    the plane must also start 4-byte aligned: an int8 add is a
    compare-and-swap of the aligned word that holds the byte (the
    allocator's tensors are; a view at an odd offset is not)."""
    if t.dtype not in COUNT_DTYPES:
        raise TypeError(f"{name}: want one of "
                        f"{', '.join(map(str, COUNT_DTYPES))}, got {t.dtype}")
    check(t, name, t.dtype, shape)
    if t.is_cuda and t.data_ptr() % 4:
        raise ValueError(f"{name}: a count plane on the card must start "
                         "4-byte aligned")


def count_code(t: torch.Tensor) -> int:
    """The kernels' code of a count plane's dtype."""
    return COUNT_DTYPES.index(t.dtype)


def check_operand(t: torch.Tensor, name: str, shape) -> None:
    """``check`` for a hash operand (x or W) of any of ``OPERAND_DTYPES``."""
    if t.dtype not in OPERAND_DTYPES:
        raise TypeError(f"{name}: want one of "
                        f"{', '.join(map(str, OPERAND_DTYPES))}, "
                        f"got {t.dtype}")
    check(t, name, t.dtype, shape)


def operand_code(t: torch.Tensor) -> int:
    """The kernels' code of a hash operand's dtype."""
    return OPERAND_DTYPES.index(t.dtype)


def check_bits(num_bits: int) -> None:
    if not 1 <= num_bits <= 31:
        raise ValueError(f"num_bits must be in [1, 31], got {num_bits}")


_tally = threading.local()


@contextlib.contextmanager
def tally_launches():
    """Within it, a launch adds to the yielded {Kernel: n} tally instead
    of ``Kernel.launches``: a CUDA graph's capture records its launches
    and runs none (``core.capture``), and each replay adds the tally back
    (``add_launches``)."""
    before = getattr(_tally, "rec", None)
    _tally.rec = rec = {}
    try:
        yield rec
    finally:
        _tally.rec = before


def add_launches(tally: dict) -> None:
    """Count a replay of a captured graph: its tally's launches."""
    for kernel, n in tally.items():
        kernel.launches += n


class Kernel:
    """One C entry point of one kernel source, with its launch counter.

    ``launches`` is a plain integer: it grows by one for each call that
    launched the kernel (and nowhere else), so a run can show that its
    main path went through the kernel.  A captured graph's replay adds
    the launches its capture recorded (``tally_launches``).
    """

    def __init__(self, source: str, symbol: str, argtypes: list):
        self.source = source
        self.symbol = symbol
        self.argtypes = [*argtypes, ctypes.c_void_p]   # + the stream
        self.launches = 0
        self._fn = None

    def _bind(self):
        lib = load(self.source)
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        err_str = lib.repro_error_string
        err_str.argtypes = [ctypes.c_int]
        err_str.restype = ctypes.c_char_p
        self._fn, self._err_str = fn, err_str
        return fn

    def __call__(self, device: torch.device, *args) -> None:
        """Launch on ``device``'s current PyTorch stream; raise if the
        launch was refused."""
        fn = self._fn or self._bind()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = fn(*args, stream)
        if err != 0:
            raise RuntimeError(f"{self.symbol}: CUDA error {err} "
                               f"({self._err_str(err).decode()})")
        rec = getattr(_tally, "rec", None)
        if rec is None:
            self.launches += 1
        else:
            rec[self] = rec.get(self, 0) + 1
