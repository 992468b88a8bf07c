"""Build the port's CUDA kernels with ``nvcc`` at first use; load with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own into
``build/repro_torch_kernels/lib<name>.so`` at the root of the checkout, for
``sm_90a``. ``build_all()`` starts one ``nvcc`` per source, all at once, and
waits for them; ``library(name)`` builds what is missing or older than its
source and returns the loaded library with its ``argtypes`` set. Nothing here
runs at import time, so the CPU tests can import every module.
"""
from __future__ import annotations

import contextlib
import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P, _I = ctypes.c_void_p, ctypes.c_int
# C signature of every entry point: pointers and the stream as c_void_p
ARGTYPES = {
    "filter_dist": {
        "filter_dist_gather_packed": [
            _P, _I, _I, _I, _P, _P, _P, _P, _I, _P, _I, _I, _P, _I, _P, _P,
            _I, _I, _I, _P, _P,
        ],
        "filter_dist_gather": [
            _P, _I, _I, _I, _P, _P, _P, _P, _I, _I, _P, _P, _P, _I, _I, _I,
            _P, _P,
        ],
        "filter_dist_dense": [_P, _P, _I, _I, _I, _P, _P, _P, _I, _P, _P],
    },
    "l2dist": {
        "l2dist": [_P, _I, _P, _I, _P, _I, _I, _I, _P, _P],
    },
    "beam_merge": {
        "beam_merge": [
            _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _I, _P, _P, _P, _P, _P,
        ],
    },
}

_lock = threading.Lock()
_libs: dict = {}
LOGS: dict = {}   # name -> nvcc's output (registers, shared memory, spills)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _stale(name: str) -> bool:
    so = BUILD_DIR / f"lib{name}.so"
    return not so.exists() or so.stat().st_mtime < (CSRC / f"{name}.cu").stat().st_mtime


def build_all(names=None) -> float:
    """Compile the stale sources in parallel; returns the seconds spent.
    Raises ``RuntimeError`` with nvcc's output when a build fails."""
    names = [n for n in (names or ARGTYPES) if _stale(n)]
    if not names:
        return 0.0
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {
        n: subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(BUILD_DIR / f"lib{n}.so.tmp"),
             str(CSRC / f"{n}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for n in names
    }
    failed = []
    for n, p in procs.items():
        out, _ = p.communicate()
        LOGS[n] = out
        if p.returncode != 0:
            failed.append(f"nvcc {n}.cu failed ({p.returncode}):\n{out}")
        else:
            os.replace(BUILD_DIR / f"lib{n}.so.tmp", BUILD_DIR / f"lib{n}.so")
    if failed:
        raise RuntimeError("\n".join(failed))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                build_all([name])
                lib = ctypes.CDLL(str(BUILD_DIR / f"lib{name}.so"))
                for fn, argtypes in ARGTYPES[name].items():
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = ctypes.c_int
                _libs[name] = lib
    return lib


def loaded(name: str):
    """The library the wrappers call for ``name`` now, or ``None`` before
    its first use; builds nothing."""
    return _libs.get(name)


@contextlib.contextmanager
def swapped(name: str, lib):
    """Within the block the wrappers call ``lib``, another build of
    ``csrc/<name>.cu``, in place of ``library(name)``: for comparing two
    builds of one source in one process."""
    keep = library(name)
    _libs[name] = lib
    try:
        yield
    finally:
        _libs[name] = keep
