"""Build the CUDA kernels of ``csrc/`` with ``nvcc`` and bind them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a plain
C interface, ``_build/lib<name>-<hash>.so`` (the hash covers the source, the
shared headers ``csrc/*.cuh`` and the flags, so an edited source rebuilds).
The build happens at first use; the sources are compiled in parallel, one
``nvcc`` process per file.  There is no fallback: a missing ``nvcc`` or a
failed compile raises.

Every wrapper counts one launch of its kernel, where it launches it and
nowhere else, as the registry's host counter ``kernel.<name>``
(``utils/profiling``); ``LAUNCHES`` is a view of those counters by kernel
name.  Inside a CUDA graph's capture they count nothing, and each replay
adds what its capture launched (``utils/profiling.captured``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from ..utils import profiling

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
SOURCES = ("window_slice", "segment_moments", "segment_sum", "ndt_linearize",
           "small_chol", "lm_step")

LAUNCHES = profiling.CounterView("kernel.", profiling.KERNELS)

_LIBS: dict = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def library_path(name: str) -> Path:
    # the shared headers enter every source's hash
    src = b"".join(p.read_bytes() for p in [CSRC / f"{name}.cu",
                                             *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names=SOURCES) -> dict:
    """Compile the libraries of ``names`` that are not built yet, all at once.

    Returns ``{name: (seconds, compiler log)}`` for the sources compiled now.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        out = library_path(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    done = {}
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for csrc/{n}.cu:\n{log}")
        os.replace(tmp, out)
        done[n] = (time.perf_counter() - t0, log)
    return done


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib
