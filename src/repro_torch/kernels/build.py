"""Builds the port's CUDA kernels at first use and counts their launches.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library with
a plain C interface, ``build/repro_torch/lib<name>-<digest>.so`` under the
repository root, loaded with ``ctypes``.  The digest covers the source and
the flags (and every header in ``csrc``), so an edited kernel rebuilds and
an unchanged one is reused, with nvcc's output kept beside it
(``lib<name>-<digest>.log``).
Nothing here runs at import: the CPU tests import every module on a host
without ``nvcc``.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: Kernel launches by kernel name.  A wrapper adds one where it launches
#: its kernel and nowhere else, so a run can show that its path went
#: through the kernels (``LAUNCHES.clear()`` before, read after).
LAUNCHES: collections.Counter = collections.Counter()

#: nvcc's output (including ptxas' register report) per library loaded by
#: this process, read back from its log where an earlier process built it.
BUILD_LOGS: dict[str, str] = {}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME); nvcc builds the kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _target(name: str) -> pathlib.Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))  # what a source includes
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(*names: str) -> None:
    """Compile the named kernels that are not built yet, one ``nvcc`` per
    source, all running at once, and reads the kept output of those that
    are (into BUILD_LOGS).  Raises with nvcc's output on failure."""
    todo = [n for n in names if not _target(n).exists()]
    for n in set(names) - set(todo) - set(BUILD_LOGS):
        log = _target(n).with_suffix(".log")
        if log.exists():
            BUILD_LOGS[n] = log.read_text()
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = _target(n).with_suffix(f".{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOGS[n] = log
        if proc.returncode:
            failed.append(f"nvcc failed for {n}.cu (exit {proc.returncode}):\n{log}")
        else:
            log_tmp = tmp.with_suffix(".log")
            log_tmp.write_text(log)
            os.replace(log_tmp, _target(n).with_suffix(".log"))
            os.replace(tmp, _target(n))
    if failed:
        raise RuntimeError("\n".join(failed))


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        if name not in _libs:
            build(name)
            _libs[name] = ctypes.CDLL(str(_target(name)))
        return _libs[name]
