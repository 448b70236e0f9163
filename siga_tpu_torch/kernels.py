"""Build, load and launch the hand-written CUDA kernels of `csrc/`.

Every `csrc/*.cu` compiles with nvcc for `sm_90a` (one nvcc per source,
all started together) and links into one shared library with a plain C
interface under `_build/`, at first use; it is loaded with ctypes.  Each C
entry point launches on the stream it is given and returns
`cudaGetLastError()`, which `check` turns into an exception.  There is no
fallback: a failed build or launch raises.

`launch` calls a C entry point with the device of its tensors made the
calling thread's current device (a ctypes call launches on whatever device
is current, so a tensor on `cuda:1` would otherwise be launched from
`cuda:0`), checks it and counts it: `launches` holds, per kernel, the
launches its wrapper made, so a run can show that its main path went
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
    "pair_plane": 0, "scan_pair": 0, "scan_single": 0, "scan_single_sharded": 0,
    "scan_stage_a": 0, "sw_wavefront": 0, "kmer_count": 0, "gather_rows": 0, "take_along": 0,
    "gather_chain": 0, "scale2": 0, "sa_seed_keys": 0, "sa_gather": 0, "sa_seed_ranks": 0,
    "sa_round_keys": 0, "sa_round_scatter": 0, "sa_bwt_perm": 0, "launch_floor": 0,
    "dist_levels": 0, "dist_bounds": 0, "dist_merge": 0, "dist_number": 0,
}

_lock = threading.Lock()
_count_lock = threading.Lock()  # shards of a chunk launch from several threads
_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    # codes, n, nblocks, pred[0..4], plane, K, scratch, stream
    "siga_pair_plane": [_P, _I, _I] + [_I] * 5 + [_P] * 4,
    # nblocks -> ints of scratch siga_pair_plane needs
    "siga_pair_plane_scratch": [_I],
    # plane, K2, pred, la_words, lens, length, nblocks, n, wpr, nfwd,
    # groups_code, lim_t, p1, t0, lanes, lane_base, nl, cap, then
    # lane_counts, fall, candmask, subwords, slab, stream
    "siga_scan_pair": [_P] * 5 + [_I] * 13 + [_P] * 5 + [_P],
    # shards (host array of nshards pointers), nshards, bps, pred, la_words,
    # lens, length, nblocks, n, wpr, nfwd, groups_code, lim_t, p1, lanes,
    # lane_base, nl, cap, then lane_counts, fall, candmask, subwords, slab,
    # stream
    "siga_scan_single": [_P, _I, _I] + [_P] * 3 + [_I] * 12 + [_P] * 5 + [_P],
    # plane, nrows, pred, length, chars, lens, lane_tab (or null), L, max_t,
    # min_overlap, emitted, valid, final, lext, stream
    "siga_scan_stage_a": [_P, _I, _P, _I, _P, _P, _P, _I, _I, _I] + [_P] * 4 + [_P],
    # peer: let the current card read that card's memory
    "siga_enable_peer_access": [_I],
    # threads a lane of siga_scan_pair and a k-mer of siga_kmer_count
    "siga_lane_group": [],
    # queries, refs, B, Q, N, match, mismatch, open, extend, i0, M,
    # carry_in, carry_out, best, qend, rend, stream
    "siga_sw_wavefront": [_P] * 2 + [_I] * 9 + [_P] * 5 + [_P],
    # plane, idx, R, Q, C, out, stream
    "siga_gather_rows": [_P, _P, _I, _I, _I, _P, _P],
    # table, index, A, B, Q, si0, si1, axis, form, tile, out, stream
    "siga_take_along": [_P, _P, _I, _I, _I, _L, _L, _I, _I, _I, _P, _P],
    # table, sw, sx, W, NB, init, c, Lc, steps, L, group, out, stream
    "siga_gather_chain_sum": [_P, _L, _L, _I, _I, _P, _P, _I, _I, _I, _I, _P, _P],
    # table, sw, sx, W, N, init, M, steps, form, tile, out, stream
    "siga_gather_chain_elem": [_P, _L, _L, _I, _I, _P, _I, _I, _I, _I, _P, _P],
    # x, n, head, nvec, out, stream
    "siga_scale2": [_P, _L, _L, _L, _P, _P],
    # stream: an empty kernel (the launch floor)
    "siga_launch_floor": [_P],
    # plane, K, pred, length, nblocks, kmers, Q, k, out, stream
    "siga_kmer_count": [_P, _P, _P, _I, _I, _P, _I, _I, _P, _P],
    # items -> 64-bit words of scratch a suffix-sort scan needs
    "siga_sa_scan_scratch": [_L],
    # c, limit, n, sentpos, key_a, key_b, upos, ucap, scratch, stream
    "siga_sa_seed_keys": [_P, _L, _I, _P, _P, _P, _P, _I, _P, _P],
    # order, idx, key, n, out_order, out_key, stream
    "siga_sa_gather": [_P, _P, _P, _L, _P, _P, _P],
    # order2, idx3, ka_s, key_b, sentpos, n, order, rank, uslot, ucap, scratch, stream
    "siga_sa_seed_ranks": [_P] * 5 + [_I] + [_P] * 3 + [_I, _P, _P],
    # upos, rank, h, n, m, key, stream
    "siga_sa_round_keys": [_P, _P, _L, _I, _I, _P, _P],
    # idx, skey, upos, uslot, m, order, rank, scratch, stream
    "siga_sa_round_scatter": [_P] * 4 + [_I] + [_P] * 4,
    # sa, c, n, reads, bwt, perm, scratch, stream
    "siga_sa_bwt_perm": [_P, _P, _I, _I, _P, _P, _P, _P],
    # idx, order, key, sentpos, codes, sents, n_sents, rid_base, m, then
    # out_pos, out_key, out_sp, out_pay, stream
    "siga_dist_levels": [_P] * 6 + [_I, _L, _L] + [_P] * 4 + [_P],
    # k1, k2, sp, pos, m, base, s_k1, s_k2, s_sp, s_pos, nsplit, out, stream
    "siga_dist_bounds": [_P] * 4 + [_L, _L] + [_P] * 4 + [_I, _P, _P],
    # a's k1, k2, sp, pos, pay, na, a_base, b's the same, then out's five
    # columns, stream
    "siga_dist_merge": [_P] * 5 + [_L, _L] + [_P] * 5 + [_L, _L] + [_P] * 5 + [_P],
    # k1, k2, sp, pos, m, prev's k1, k2, sp, pos, off, tabs (host array of
    # ntabs pointers), ntabs, seg, scratch, stream
    "siga_dist_number": [_P] * 4 + [_L] + [_P] * 4 + [_L, _P, _I, _L, _P, _P],
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


def launch(name: str, device: torch.device, entry, *args) -> None:
    """entry(*args, stream) with `device` the current device and its current
    stream last; raises on a failed launch, else counts one for `name`."""
    with torch.cuda.device(device):
        rc = entry(*args, stream_ptr(device))
    check(rc, name)
    with _count_lock:
        launches[name] += 1


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0
