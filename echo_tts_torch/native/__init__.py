"""Native (C) host-DSP kernels, compiled on demand and loaded via ctypes.

A copy of echo_tts_tpu/native.  Build: `gcc -O3 -shared -fPIC dsp.c` into
`<build root>/native` (ops/cuda_build.py:build_root) on first use.  Every
entry point has a numpy fallback, so the package works without a
toolchain; `available()` reports which path is active.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Optional

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "dsp.c")
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _build_and_load() -> Optional[ctypes.CDLL]:
    try:
        from ..ops.cuda_build import build_root
        with open(_SRC, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()[:16]
        cache_dir = str(build_root() / "native")
        os.makedirs(cache_dir, exist_ok=True)
        lib_path = os.path.join(cache_dir, f"dsp_{digest}.so")
        if not os.path.exists(lib_path):
            tmp = lib_path + ".tmp"
            subprocess.run(
                ["gcc", "-O3", "-shared", "-fPIC", "-o", tmp, _SRC, "-lm"],
                check=True, capture_output=True)
            os.replace(tmp, lib_path)
        lib = ctypes.CDLL(lib_path)
        lib.echo_trailing_silence.restype = ctypes.c_long
        lib.echo_trailing_silence.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_long, ctypes.c_float]
        lib.echo_flattening_point.restype = ctypes.c_long
        lib.echo_flattening_point.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_long, ctypes.c_long,
            ctypes.c_long, ctypes.c_float, ctypes.c_float]
        return lib
    except Exception:
        return None


def _lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if not _TRIED:
        _TRIED = True
        _LIB = _build_and_load()
    return _LIB


def available() -> bool:
    return _lib() is not None


def _f32ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def trailing_silence(x: np.ndarray, threshold: float) -> int:
    """Trailing samples with |x| < threshold (reference: handler.py:210-218
    inner loop)."""
    x = np.ascontiguousarray(x, dtype=np.float32).ravel()
    lib = _lib()
    if lib is not None:
        return int(lib.echo_trailing_silence(
            _f32ptr(x), x.size, ctypes.c_float(threshold)))
    # numpy fallback: index of last loud sample
    loud = np.abs(x) >= threshold
    if not loud.any():
        return x.size
    return int(x.size - 1 - np.flatnonzero(loud)[-1])


def flattening_point(data: np.ndarray, target: float = 0.0,
                     window: int = 20, std_threshold: float = 0.05
                     ) -> Optional[int]:
    """First flat window index, or None to use the numpy implementation
    (pipeline/dsp.py)."""
    lib = _lib()
    if lib is None:
        return None
    data = np.ascontiguousarray(data, dtype=np.float32)
    if data.ndim == 1:
        data = data[:, None]
    elif data.ndim > 2:
        # match the numpy fallback, which flattens trailing feature dims
        data = data.reshape(len(data), -1)
    n, width = data.shape
    return int(lib.echo_flattening_point(
        _f32ptr(data), n, width, window,
        ctypes.c_float(target), ctypes.c_float(std_threshold)))
