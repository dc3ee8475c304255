"""Build the CUDA kernels at first use and load them with ctypes.

Each ``phendiff_tpu_torch/csrc/<name>.cu`` has a plain C interface and
compiles on its own, with ``nvcc`` for ``sm_90a`` (Hopper), into a shared
library under ``phendiff_tpu_torch/build/`` (git-ignored).  The library's
file name carries a hash of its source and flags, so an edited source is
rebuilt and a stale library is never loaded.  Nothing here runs when the
package is imported: the first kernel call builds, or a caller builds all
kernels at once with ``build()`` (one ``nvcc`` process per source, all
started together).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"

KERNELS = ("flash_attn_fwd", "group_norm_silu")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Compile every named kernel whose library is missing, all in parallel.

    Returns each built kernel's compiler log (``ptxas -v``: registers, shared
    memory and spills per kernel); raises with the log if one fails.
    """
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True),
            tmp, out,
        )
    logs, failed = {}, {}
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode == 0:
            os.replace(tmp, out)  # atomic: a concurrent build never loads half a file
        else:
            failed[name] = log
    if failed:
        raise RuntimeError(
            "nvcc failed:\n" + "\n".join(f"--- {n}\n{log}" for n, log in failed.items())
        )
    return logs


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built first if needed."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))


def check(err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error (a refused launch never runs
    and no later synchronize reports it)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
