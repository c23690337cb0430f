"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C interface. It is compiled with
``nvcc`` for ``sm_90a`` into ``build/lib<name>.so`` at the repository root on
first use (rebuilt when the source or a ``csrc/*.cuh`` header it may include
is newer) and loaded with ``ctypes``.
Building needs CUDA and ``nvcc``; without them this raises, and nothing
falls back to another implementation.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Iterable, List, Optional

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    """Missing, or older than its source or any shared header."""
    lib = _library_path(name)
    if not lib.exists():
        return True
    sources = [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")]
    return lib.stat().st_mtime < max(s.stat().st_mtime for s in sources)


def build(names: Optional[Iterable[str]] = None) -> List[str]:
    """Compile the named sources (default: every ``csrc/*.cu``) that are
    missing or stale, all nvcc processes started together. Returns the
    names built. Raises with nvcc's output on failure."""
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the CUDA kernels cannot be built")
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    todo = [n for n in names if _stale(n)]
    if not todo:
        return []
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in todo:
        # Write to a temporary file first so a concurrent loader never maps a
        # half-written library.
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    failures = []
    for name, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{out}")
            os.unlink(tmp)
        else:
            os.replace(tmp, _library_path(name))
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return todo


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<name>.cu``, built if needed."""
    build([name])
    return ctypes.CDLL(str(_library_path(name)))
