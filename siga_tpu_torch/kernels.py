"""Build, load and launch the hand-written CUDA kernels of `csrc/`.

Every `csrc/*.cu` compiles with nvcc for `sm_90a` (one nvcc per source,
all started together) and links into one shared library with a plain C
interface under `_build/`, at first use; it is loaded with ctypes.  Each C
entry point launches on the stream it is given and returns
`cudaGetLastError()`, which `check` turns into an exception.  There is no
fallback: a failed build or launch raises.

`launches` counts, per kernel, the launches its wrapper made (each wrapper
adds one where it launches), so a run can show that its main path went
through the kernel.
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
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

launches = {
    "scan_pair": 0, "sw_wavefront": 0, "kmer_count": 0,
    "gather_rows": 0, "take_along": 0, "gather_chain": 0, "scale2": 0,
}

_lock = threading.Lock()
_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    # plane, K2, pred, la_words, lens, length, nblocks, n, wpr, nfwd,
    # groups_code, lim_t, p1, t0, lanes, then outputs, stream
    "siga_scan_pair_count": [_P] * 5 + [_I] * 10 + [_P] * 4 + [_P],
    "siga_scan_pair_emit": [_P] * 5 + [_I] * 10 + [_P] * 2 + [_P],
    # queries, refs, B, M, N, match, mismatch, open, extend, best, qend,
    # rend, stream
    "siga_sw_wavefront": [_P] * 2 + [_I] * 7 + [_P] * 3 + [_P],
    # plane, idx, R, Q, C, out, stream
    "siga_gather_rows": [_P, _P, _I, _I, _I, _P, _P],
    # table, index, A, B, Q, si0, si1, axis, out, stream
    "siga_take_along": [_P, _P, _I, _I, _I, _L, _L, _I, _P, _P],
    # table, sw, sx, W, NB, init, c, Lc, steps, L, out, stream
    "siga_gather_chain_sum": [_P, _L, _L, _I, _I, _P, _P, _I, _I, _I, _P, _P],
    # table, sw, sx, W, N, init, M, steps, out, stream
    "siga_gather_chain_elem": [_P, _L, _L, _I, _I, _P, _I, _I, _P, _P],
    # x, n, out, stream
    "siga_scale2": [_P, _L, _P, _P],
    # plane, K, pred, length, nblocks, kmers, Q, k, out, stream
    "siga_kmer_count": [_P, _P, _P, _I, _I, _P, _I, _I, _P, _P],
}


def nvcc() -> str:
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    return path if os.path.exists(path) else "nvcc"


def build() -> str:
    """Compile `csrc/*.cu` into LIB_PATH (when missing or older than a
    source or header); returns the compiler's report (registers, spills)."""
    sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    headers = glob.glob(os.path.join(CSRC, "*.cuh"))
    if os.path.exists(LIB_PATH) and os.path.getmtime(LIB_PATH) >= max(
        os.path.getmtime(s) for s in sources + headers
    ):
        return ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    objects = [
        os.path.join(BUILD_DIR, f"{os.path.basename(src)[:-3]}.{tag}.o") for src in sources
    ]
    procs = [
        subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-c", "-o", obj, src],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for src, obj in zip(sources, objects)
    ]
    errs = [proc.communicate()[1] for proc in procs]  # waits for each
    try:
        failed = [
            f"{src} ({proc.returncode}):\n{err}"
            for src, proc, err in zip(sources, procs, errs)
            if proc.returncode != 0
        ]
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        tmp = f"{LIB_PATH}.{tag}"
        proc = subprocess.run(
            [nvcc(), "-shared", "-o", tmp, *objects], capture_output=True, text=True
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, LIB_PATH)
    finally:
        for obj in objects:
            if os.path.exists(obj):
                os.remove(obj)
    return "".join(errs)


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
