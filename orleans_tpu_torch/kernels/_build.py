"""Build and load the CUDA sources in ``orleans_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``.  The
library lands in ``build/orleans_tpu_torch/`` at the repository root under
a name that carries a hash of its sources and flags, so an edited source
rebuilds and an unchanged one loads at once.  ``build_all`` starts one
``nvcc`` per source, all together.

Nothing here runs at import: the CPU tests import every module, and this
machine class has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "orleans_tpu_torch"
SOURCES = ("resolve", "scatter", "segment", "hist", "miss", "attr_fold",
           "attr_apply", "attr_snapshot", "resolve_wide", "fanout",
           "lifecycle", "timers", "pull", "replicas", "checkpoint",
           "router", "exchange")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

# name → loaded library (one load per process)
_LIBS: Dict[str, ctypes.CDLL] = {}
# kernel wrappers that count their launches (see ``counted``)
_COUNTED: List[Callable] = []
# (kernel, device, stream) -> (size, state every launch leaves as made)
_STREAM_POOLS: Dict[Tuple[str, torch.device, int], Tuple[int, Any]] = {}


def counted(fn: Callable) -> Callable:
    """Register a kernel wrapper that counts its launches of its CUDA
    kernel (never its plain version), in three attributes:

    * ``launches``: launches made eagerly, one per wrapper call;
    * ``captured``: launches recorded into a CUDA graph during capture —
      these run only when the graph replays;
    * ``replayed``: launches made by graph replays, added by
      ``note_replay`` from the per-capture counts of the replayed graph.

    ``launches + replayed`` is what the device ran."""
    fn.launches = 0
    fn.captured = 0
    fn.replayed = 0
    _COUNTED.append(fn)
    return fn


def note_launch(fn: Callable) -> None:
    """Count one launch of ``fn``'s kernel, as captured when the current
    stream is capturing a CUDA graph, else as an eager launch."""
    if torch.cuda.is_current_stream_capturing():
        fn.captured += 1
    else:
        fn.launches += 1


def captured_counts() -> Dict[str, int]:
    """Captured launches per wrapper, for a capture's before/after diff."""
    return {fn.__name__: fn.captured for fn in _COUNTED}


def note_replay(per_capture: Dict[str, int]) -> None:
    """One replay of a graph whose capture recorded ``per_capture``."""
    for fn in _COUNTED:
        fn.replayed += per_capture.get(fn.__name__, 0)


def launch_counts() -> Dict[str, int]:
    """Launches the device ran per wrapper: eager plus replayed."""
    return {fn.__name__: fn.launches + fn.replayed for fn in _COUNTED}


def launch_report() -> Dict[str, Dict[str, int]]:
    """Per wrapper: eager launches, launches captured into graphs, and
    launches those graphs' replays made."""
    return {fn.__name__: {"eager": fn.launches, "captured": fn.captured,
                          "replayed": fn.replayed} for fn in _COUNTED}


def reset_launch_counts() -> None:
    for fn in _COUNTED:
        fn.launches = fn.captured = fn.replayed = 0


def stream_pool(kernel: str, device: torch.device,
                make: Callable[[int], Any], size: int = 1) -> Any:
    """The state ``kernel``'s launches start from, ``make(n)`` for some
    ``n >= size``.  Eagerly, a pool per (kernel, device, stream), made once
    and left as made by every launch, so no call clears it first; a larger
    ``size`` replaces a smaller pool.  While a CUDA graph captures,
    ``make(size)`` inside the graph, so every replay starts from it."""
    if torch.cuda.is_current_stream_capturing():
        return make(size)
    key = (kernel, device, torch.cuda.current_stream(device).cuda_stream)
    pool = _STREAM_POOLS.get(key)
    if pool is None or pool[0] < size:
        pool = _STREAM_POOLS[key] = (size, make(size))
    return pool[1]


def drop_pool(kernel: str, device: torch.device) -> None:
    """Forget the current stream's pool of ``kernel`` (a launch that failed
    may have left it dirty): the next launch makes a new one."""
    _STREAM_POOLS.pop(
        (kernel, device, torch.cuda.current_stream(device).cuda_stream),
        None)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "of orleans_tpu_torch build only where the CUDA "
                       "toolkit is installed")


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every source whose library is missing, one ``nvcc`` each,
    all started together; returns name → library path."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {name: _target(name) for name in SOURCES}
    jobs = []
    for name, target in targets.items():
        if target.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, proc, tmp, target))
    failed = []
    for name, proc, tmp, target in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{out}")
            Path(tmp).unlink(missing_ok=True)
        else:
            os.replace(tmp, target)  # atomic: concurrent builds agree
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return targets


def library(name: str, signatures: Dict[str, tuple],
            init: Optional[str] = None) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built on first use) with
    ``argtypes`` set from ``signatures`` (function → argtypes); every
    function returns a ``cudaError_t`` as ``int``.  ``init`` names a
    function of no arguments called once, when the library loads (its
    kernels' attributes, set before any graph can capture them)."""
    lib = _LIBS.get(name)
    if lib is None:
        path = _target(name)
        if not path.exists():
            build_all()
        lib = ctypes.CDLL(str(path))
        for fn_name, argtypes in signatures.items():
            fn = getattr(lib, fn_name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        lib.ot_error_string.argtypes = [ctypes.c_int]
        lib.ot_error_string.restype = ctypes.c_char_p
        if init is not None:
            check(lib, getattr(lib, init)(), init)
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch reported an error (``cudaGetLastError``)."""
    if err != 0:
        msg = lib.ot_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
