"""Build and load the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled on first
use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v

into `<build root>/kernels/lib<name>_<source hash>.so`, then loaded with
ctypes.  No `--use_fast_math`: it would turn the residual stack's exact
`sinf` into `__sinf`.  The build root is `build/` beside the package (git
ignores it) unless ECHO_TORCH_BUILD_DIR names another one.  Nothing is
built when a module is imported, and nothing at all without a CUDA device.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
KERNELS = ("joint_attention", "res_stack")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def build_root() -> Path:
    env = os.environ.get("ECHO_TORCH_BUILD_DIR")
    return Path(env) if env else CSRC.parent.parent / "build"


def build_dir() -> Path:
    return build_root() / "kernels"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA "
                           "kernels are built on the machine with the card")
    return found


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return build_dir() / f"lib{name}_{digest}.so"


def _require_cuda() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("the port's CUDA kernels need a CUDA device; CPU "
                           "tensors take the plain PyTorch versions")


def build(names: Iterable[str] = KERNELS) -> Dict[str, float]:
    """Compile every kernel that is not built yet, one nvcc per source, all
    started together.  Returns {name: seconds}; the compiler's output
    (ptxas register and shared-memory report) is kept beside each library
    as `<lib>.log`."""
    _require_cuda()
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        lib = _lib_path(name)
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib, time.perf_counter())
    seconds = {}
    errors = []
    for name, (proc, tmp, lib, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        lib.with_suffix(".so.log").write_text(log)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
        else:
            os.replace(tmp, lib)
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def build_log(name: str) -> str:
    path = _lib_path(name).with_suffix(".so.log")
    return path.read_text() if path.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            if not _lib_path(name).exists():
                build([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            _LIBS[name] = lib
        return lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launcher."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
