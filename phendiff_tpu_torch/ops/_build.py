"""Build the CUDA kernels at first use and load them with ctypes.

Each ``phendiff_tpu_torch/csrc/<name>.cu`` has a plain C interface and
compiles on its own, with ``nvcc`` for ``sm_90a`` (Hopper), into a shared
library under ``phendiff_tpu_torch/build/`` (git-ignored).  The library's
file name carries a hash of its source, of every shared header
(``csrc/*.cuh``) and of the flags, so an edited source or header is rebuilt
and a stale library is never loaded.  Nothing here runs when the
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

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"

KERNELS = ("flash_attn_fwd", "flash_attn_bwd", "group_norm_silu", "adaln_norm",
           "residual_bias")

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
    """Where the library of ``csrc/<name>.cu`` is built: its name hashes the
    source, every ``csrc/*.cuh`` and the flags."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Compile every named kernel whose library is missing, all in parallel.

    Returns each named kernel's compiler log (``ptxas -v``: registers, shared
    memory and spills per kernel), kept beside its library, so a library
    built earlier reports the log of its build; raises with the log if one
    fails.
    """
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs, logs = {}, {}
    for name in names:
        out = library_path(name)
        if out.exists():
            log_path = out.with_suffix(".log")
            logs[name] = log_path.read_text() if log_path.exists() else ""
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True),
            tmp, out,
        )
    failed = {}
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode == 0:
            out.with_suffix(".log").write_text(log)
            os.replace(tmp, out)  # atomic: a concurrent build never loads half a file
        else:
            failed[name] = log
    if failed:
        raise RuntimeError(
            "nvcc failed:\n" + "\n".join(f"--- {n}\n{log}" for n, log in failed.items())
        )
    return logs


def ptxas_functions(log: str) -> Dict[str, Dict[str, int]]:
    """Per compiled function of a ``ptxas -v`` log (its mangled name): the
    registers it uses, its spill bytes (stores + loads) and its stack frame
    bytes (local memory, spilled or not: an array the compiler cannot keep
    in registers)."""
    out: Dict[str, Dict[str, int]] = {}
    fn = None
    for line in log.splitlines():
        if "Function properties for " in line:
            fn = line.split("Function properties for ", 1)[1].strip()
            out[fn] = {}
        elif fn and "spill stores" in line:
            nums = [int(x) for x in line.replace(",", " ").split() if x.isdigit()]
            out[fn]["spill_bytes"] = nums[1] + nums[2]
            out[fn]["stack_bytes"] = nums[0]
        elif fn and "Used " in line and " registers" in line:
            out[fn]["registers"] = int(line.split("Used ", 1)[1].split()[0])
    return out


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built first if needed."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))


def check(err: int, what: str) -> None:
    """Raise if a C entry returned an error: a positive CUDA error code (a
    refused launch never runs and no later synchronize reports it), or an
    entry's own negative code (a launch plan it refused, -1; a TMA
    descriptor that could not be encoded, -1000 - its CUresult)."""
    if err != 0:
        raise RuntimeError(f"{what}: error {err}")


def on_tensor_device(fn):
    """Run ``fn(x, ...)`` with the current CUDA device set to ``x``'s (a
    CPU tensor runs as it is).  The C entries launch on the current device
    and do their once-per-device setup for it, so a call on another card
    than the current one (a process of a data-parallel group, or any
    multi-card caller) launches where its tensors are."""

    @functools.wraps(fn)
    def wrapped(x, *args, **kw):
        if x.device.type != "cuda":
            return fn(x, *args, **kw)
        with torch.cuda.device(x.device):
            return fn(x, *args, **kw)

    return wrapped
