"""Build and load the port's CUDA kernels.

Each ``<name>/<name>.cu`` under this directory is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, at first CUDA
use, and loaded with ``ctypes``. Libraries go to ``build/repro_torch/`` at
the repository root, named by a hash of the sources and flags, so a changed
source is rebuilt and an unchanged one is reused. Nothing here runs at
import time: ``import repro_torch`` needs neither ``nvcc`` nor CUDA.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List, Sequence

KERNEL_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNEL_DIR.parents[2] / "build" / "repro_torch"
KERNELS = ("flash_attention", "flash_decode", "ssd_scan", "moe_ffn")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("repro_torch: nvcc not found (PATH, CUDA_HOME, "
                       "/usr/local/cuda); the CUDA kernels cannot be built")


def _source(name: str) -> Path:
    return KERNEL_DIR / name / f"{name}.cu"


_LOCAL_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def inputs(name: str) -> List[Path]:
    """The kernel's source and every local header it includes, directly or
    through another header (``#include "..."``), in a fixed order."""
    seen, todo = [], [_source(name)]
    while todo:
        path = todo.pop(0).resolve()
        if path in seen:
            continue
        seen.append(path)
        for inc in _LOCAL_INCLUDE.findall(path.read_text()):
            todo.append(path.parent / inc)
    return seen


def library_path(name: str) -> Path:
    """Content-hashed path of the kernel's shared library: the flags, the
    source and every header it includes."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in inputs(name):
        h.update(path.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _compile_cmd(name: str, tmp: Path) -> List[str]:
    return [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_source(name))]


def build(names: Sequence[str] = KERNELS) -> Dict[str, str]:
    """Compile every missing library of ``names``, one ``nvcc`` process per
    source, all started together. Returns each name's compiler output
    (``-Xptxas -v``: registers, shared memory, spills); raises
    ``RuntimeError`` if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        procs[name] = (subprocess.Popen(
            _compile_cmd(name, Path(tmp)), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), Path(tmp), out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{name} (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("repro_torch: nvcc failed for " + "\n".join(failed))
    return logs


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The kernel's library, built first if it is missing."""
    path = library_path(name)
    if not path.exists():
        build([name])
    return ctypes.CDLL(str(path))
