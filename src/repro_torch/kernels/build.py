"""Build and load the Hopper kernels (no reference module: the JAX package
compiles its Pallas kernels inside ``jit``).

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, all sources in parallel, once per
process, at first use, into ``build/kernels/`` at the repository root (which
``.gitignore`` lists).  The libraries are loaded with ``ctypes``.  Nothing
here runs when the module is imported, so the CPU tests import it freely.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_reports: Dict[str, str] = {}


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the Hopper kernels are built on a "
                       "machine with the CUDA toolkit")


def build_all() -> Dict[str, ctypes.CDLL]:
    """Compile every ``csrc/*.cu`` (one ``nvcc`` each, started together) and
    load the results; later calls in the same process return the cache."""
    with _lock:
        if _libs:
            return _libs
        nvcc = nvcc_path()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for src in sorted(CSRC_DIR.glob("*.cu")):
            # a per-process name, renamed into place once built, so that
            # concurrent processes never load a half-written library
            tmp = BUILD_DIR / f"{src.stem}.{os.getpid()}.so"
            procs[src.stem] = (tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        failed = []
        built = {}
        for name, (tmp, proc) in procs.items():
            out, _ = proc.communicate()
            _reports[name] = out
            if proc.returncode != 0:
                failed.append(f"{name}.cu (exit {proc.returncode}):\n{out}")
                continue
            final = BUILD_DIR / f"{name}.so"
            os.replace(tmp, final)
            built[name] = final
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        for name, path in built.items():
            _libs[name] = ctypes.CDLL(str(path))
        return _libs


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu``."""
    libs = build_all()
    if name not in libs:
        raise KeyError(f"no kernel source csrc/{name}.cu")
    return libs[name]


def ptxas_reports() -> Dict[str, str]:
    """What ``nvcc -Xptxas -v`` printed for each source (after a build)."""
    build_all()
    return dict(_reports)
