"""Build, load and launch the hand-written CUDA kernels of `csrc/`.

Every `csrc/*.cu` compiles with nvcc for `sm_90a` into one shared library
with a plain C interface under `_build/`, at first use; it is loaded with
ctypes.  Each C entry point launches on the stream it is given and returns
`cudaGetLastError()`, which `check` turns into an exception.  There is no
fallback: a failed build or launch raises.

`launches` counts, per kernel, the calls of its wrapper that launched it, so
a run can show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes
import glob
import os
import subprocess
import threading

import torch

from .device import BUILD_DIR

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
LIB_PATH = os.path.join(BUILD_DIR, "libsiga_tpu_torch_kernels.so")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

launches = {"scan_pair": 0, "sw_wavefront": 0}

_lock = threading.Lock()
_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # plane, K2, pred, la_words, lens, length, nblocks, n, wpr, nfwd,
    # groups_code, lim_t, p1, t0, lanes, then outputs, stream
    "siga_scan_pair_count": [_P] * 5 + [_I] * 10 + [_P] * 4 + [_P],
    "siga_scan_pair_emit": [_P] * 5 + [_I] * 10 + [_P] * 2 + [_P],
    # queries, refs, B, M, N, match, mismatch, open, extend, best, qend,
    # rend, stream
    "siga_sw_wavefront": [_P] * 2 + [_I] * 7 + [_P] * 3 + [_P],
}


def nvcc() -> str:
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    return path if os.path.exists(path) else "nvcc"


def build() -> str:
    """Compile `csrc/*.cu` into LIB_PATH (when missing or older than a
    source); returns the compiler's report (registers, spills)."""
    sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    if os.path.exists(LIB_PATH) and os.path.getmtime(LIB_PATH) >= max(
        os.path.getmtime(s) for s in sources
    ):
        return ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    proc = subprocess.run(
        [nvcc(), *NVCC_FLAGS, "-o", tmp, *sources],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, LIB_PATH)
    return proc.stderr


def lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            build()
            handle = ctypes.CDLL(LIB_PATH)
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            handle.siga_cuda_error_string.argtypes = [ctypes.c_int]
            handle.siga_cuda_error_string.restype = ctypes.c_char_p
            _lib = handle
    return _lib


def check(rc: int, name: str) -> None:
    if rc != 0:
        msg = lib().siga_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc}: {msg}")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0
