"""Native (C++) runtime components, loaded via ctypes.

Built on first use with g++ (no external build deps) for the host it runs
on; the shared object is cached under the package's `_build/` (never
tracked).  Falls back cleanly when a compiler is missing — callers check
`available()`; the port's `device.native_lib` raises instead.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import List, Optional, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(os.path.dirname(_DIR), "_build", "libsiga_native.so")
_SRC = [os.path.join(_DIR, "extractor.cpp"), os.path.join(_DIR, "paired.cpp")]

_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> Optional[ctypes.CDLL]:
    newest_src = max(os.path.getmtime(s) for s in _SRC)
    if not os.path.exists(_SO) or os.path.getmtime(_SO) < newest_src:
        os.makedirs(os.path.dirname(_SO), exist_ok=True)
        cmd = [
            "g++",
            "-O3",
            "-march=native",
            "-fopenmp",
            "-shared",
            "-fPIC",
            "-o",
            _SO,
        ] + _SRC
        subprocess.run(cmd, check=True, capture_output=True)
    return ctypes.CDLL(_SO)


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is None and not _tried:
            _tried = True
            try:
                lib = _build()
                lib.siga_extract_irreducible.restype = ctypes.c_int64
                lib.siga_process_chunk.restype = ctypes.c_int64
                lib.siga_format_hits.restype = ctypes.c_int64
                lib.siga_pack_planes.restype = None
                lib.siga_build_sa.restype = None
                lib.siga_paired_links.restype = ctypes.c_int64
                lib.siga_paired_free.restype = None
                lib.siga_pack_reads_2bit.restype = ctypes.c_int64
                _lib = lib
            except Exception:
                _lib = None
    return _lib


def available() -> bool:
    return get_lib() is not None


def _i64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _u64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


OCC_SAMPLE = 64  # symbols per checkpoint block, must match extractor.cpp


def pack_index_planes(index):
    """Pack an FMIndex into the C++ occ planes: 2-bit symbol words ('$'
    aliases A), '$' bitmask words, cumulative checkpoint counts every
    OCC_SAMPLE symbols, predecessor counts.  The packing itself runs in C++
    (siga_pack_planes) — the numpy version cost ~0.5 s / 10 Mchar on the
    `siga overlap` load path."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError(
            "native library unavailable: pack_index_planes requires the C++ "
            "extractor (callers must gate on native.available())"
        )
    codes = np.ascontiguousarray(index.codes, dtype=np.uint8)
    n = codes.size
    nblocks = n // OCC_SAMPLE + 1
    words = np.empty(nblocks * 2, dtype=np.uint64)
    dollars = np.empty(nblocks, dtype=np.uint64)
    ckpt = np.empty(nblocks * 5, dtype=np.int64)
    lib.siga_pack_planes(
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(n),
        _u64(words),
        _u64(dollars),
        _i64(ckpt),
    )
    pred = np.ascontiguousarray(index.pred.astype(np.int64))
    return (words, dollars, ckpt, pred, n)


def _index_args(planes):
    words, dollars, ckpt, pred, n = planes
    return (_u64(words), _u64(dollars), _i64(ckpt), _i64(pred), ctypes.c_int64(n))


class NativeExtractor:
    """ctypes facade over siga_extract_irreducible."""

    def __init__(self, fmi, rfmi, threads: int = 0):
        self.lib = get_lib()
        assert self.lib is not None
        self.threads = threads
        self.fwd = pack_index_planes(fmi)
        self.rev = pack_index_planes(rfmi)

    def run(
        self, tasks: List[np.ndarray]
    ) -> Tuple[List[np.ndarray], np.ndarray]:
        """tasks: list of (n_blocks_i, 10) int64 arrays.

        Returns (per-task emitted (k_i, 10) arrays, failed flags)."""
        n_tasks = len(tasks)
        offsets = np.zeros(n_tasks + 1, dtype=np.int64)
        for i, t in enumerate(tasks):
            offsets[i + 1] = offsets[i] + len(t)
        total_in = int(offsets[-1])
        blocks = (
            np.concatenate(tasks).astype(np.int64)
            if total_in
            else np.zeros((0, 10), dtype=np.int64)
        )
        blocks = np.ascontiguousarray(blocks.reshape(-1))

        out_counts = np.zeros(n_tasks, dtype=np.int64)
        out_failed = np.zeros(n_tasks, dtype=np.uint8)
        cap = max(4 * total_in * 10, 1024)
        while True:
            out_blocks = np.empty(cap, dtype=np.int64)
            total = self.lib.siga_extract_irreducible(
                ctypes.c_int64(n_tasks),
                _i64(offsets),
                _i64(blocks),
                *_index_args(self.fwd),
                *_index_args(self.rev),
                ctypes.c_int64(cap),
                _i64(out_blocks),
                _i64(out_counts),
                out_failed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                ctypes.c_int64(self.threads),
            )
            if total >= 0:
                break
            cap *= 4
        out = []
        off = 0
        for i in range(n_tasks):
            k = int(out_counts[i])
            out.append(out_blocks[off : off + k * 10].reshape(k, 10).copy())
            off += k * 10
        return out, out_failed


def build_sa(codes: np.ndarray) -> np.ndarray:
    """Host suffix array over the sentinel-separated rank text (C++
    seed-sort + tied-group doubling; order identical to the device builder
    and index/sa.py::suffix_array_numpy)."""
    lib = get_lib()
    assert lib is not None
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    out = np.empty(codes.size, dtype=np.int64)
    lib.siga_build_sa(
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(codes.size),
        _i64(out),
    )
    return out


def format_hits(idxs, substring, arrays) -> Tuple[bytes, np.ndarray]:
    """Serialize hit records to the .hits text format in C++.

    idxs: int64 [n] read indices; substring: bool/uint8 [n]; arrays: list of
    (k_i, 10) int64 block arrays.  Returns (blob, line_offsets[n+1]) where
    blob[line_offsets[i]:line_offsets[i+1]] is read i's '\\n'-terminated
    line — format identical to overlap/builder.py Hit.serialize() + '\\n'."""
    lib = get_lib()
    assert lib is not None
    n = len(arrays)
    counts = np.fromiter((len(a) for a in arrays), dtype=np.int64, count=n)
    total = int(counts.sum())
    blocks = (
        np.ascontiguousarray(np.concatenate(arrays).astype(np.int64).reshape(-1))
        if total
        else np.zeros(0, dtype=np.int64)
    )
    idxs = np.ascontiguousarray(np.asarray(idxs, dtype=np.int64))
    subs = np.ascontiguousarray(np.asarray(substring, dtype=np.uint8))
    cap = n * (3 * 21 + 2) + total * 10 * 21
    out = ctypes.create_string_buffer(cap)
    offsets = np.zeros(n + 1, dtype=np.int64)
    written = lib.siga_format_hits(
        ctypes.c_int64(n),
        _i64(idxs),
        subs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        _i64(counts),
        _i64(blocks),
        ctypes.c_int64(cap),
        out,
        _i64(offsets),
    )
    assert written >= 0
    return out.raw[:written], offsets


class NativeChunkProcessor:
    """ctypes facade over siga_process_chunk: stages B+C for a whole chunk."""

    def __init__(self, fmi, rfmi, threads: int = 0):
        self.lib = get_lib()
        assert self.lib is not None
        self.threads = threads
        ext = NativeExtractor(fmi, rfmi, threads)
        self.fwd = ext.fwd
        self.rev = ext.rev

    def run(
        self,
        read_lens: np.ndarray,
        rc: bool,
        irreducible: bool,
        lane_stride: int,
        f_scan,
        r_scan,
    ):
        """f_scan/r_scan: (starts, t, data, final, lext) numpy arrays from
        DualScanner.collect via ops/search.py (blocks sorted by lane; lext
        carries the device-computed full substring flags).  Returns
        (per-read block arrays, substring flags, failed flags)."""
        n_reads = len(read_lens)

        def prep(scan):
            starts, t, data, final, lext = scan
            return (
                np.ascontiguousarray(starts.astype(np.int64, copy=False)),
                np.ascontiguousarray(t.astype(np.int64, copy=False)),
                np.ascontiguousarray(
                    data.astype(np.int64, copy=False).reshape(-1)
                ),
                np.ascontiguousarray(
                    final.astype(np.int64, copy=False).reshape(-1)
                ),
                np.ascontiguousarray(lext.astype(np.uint8, copy=False)),
            )

        f = prep(f_scan)
        r = prep(r_scan)
        lens64 = np.ascontiguousarray(read_lens.astype(np.int64))
        out_counts = np.zeros(n_reads, dtype=np.int64)
        out_substring = np.zeros(n_reads, dtype=np.uint8)
        out_failed = np.zeros(n_reads, dtype=np.uint8)
        total_in = (len(f[1]) + len(r[1]) + 8 * n_reads) * 10
        cap = max(4 * total_in, 4096)
        u8 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        while True:
            out_blocks = np.empty(cap, dtype=np.int64)
            total = self.lib.siga_process_chunk(
                ctypes.c_int64(n_reads),
                _i64(lens64),
                ctypes.c_int(1 if rc else 0),
                ctypes.c_int(1 if irreducible else 0),
                ctypes.c_int(1),  # lext holds full device substring flags
                ctypes.c_int64(lane_stride),
                _i64(f[0]), _i64(f[1]), _i64(f[2]), _i64(f[3]), u8(f[4]),
                _i64(r[0]), _i64(r[1]), _i64(r[2]), _i64(r[3]), u8(r[4]),
                *_index_args(self.fwd),
                *_index_args(self.rev),
                ctypes.c_int64(cap),
                _i64(out_blocks),
                _i64(out_counts),
                u8(out_substring),
                u8(out_failed),
                ctypes.c_int64(self.threads),
            )
            if total >= 0:
                break
            cap *= 4
        # per-read VIEWS into the flat output buffer (numpy views hold the
        # base alive); 10k small .copy() calls cost ~20 ms/chunk on this host
        offs = np.zeros(n_reads + 1, dtype=np.int64)
        np.cumsum(out_counts, out=offs[1:])
        out = [
            out_blocks[offs[i] * 10 : offs[i + 1] * 10].reshape(-1, 10)
            for i in range(n_reads)
        ]
        return out, out_substring, out_failed


def paired_links(
    seq_bytes: np.ndarray,
    seq_off: np.ndarray,
    eptr: np.ndarray,
    e_end: np.ndarray,
    e_dir: np.ndarray,
    e_comp: np.ndarray,
    e_dist: np.ndarray,
    e_ext: np.ndarray,
    mate: np.ndarray,
    order: np.ndarray,
    max_distance: int,
    max_nodes: int,
    insert_delta: int,
    threads: int = 0,
) -> np.ndarray:
    """Run the native PairedReadVisitor core (paired.cpp).

    Returns (n, 5) int64 confirmed create-edge rows
    [v1, v2, distance, dir, comp] in the exact order the Python postvisit
    would create them."""
    lib = get_lib()
    assert lib is not None
    nv = seq_off.size - 1
    out_ptr = ctypes.POINTER(ctypes.c_int64)()

    def u8(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))

    def i32(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

    n = lib.siga_paired_links(
        ctypes.c_int64(nv),
        u8(seq_bytes),
        _i64(seq_off),
        _i64(eptr),
        i32(e_end),
        u8(e_dir),
        u8(e_comp),
        i32(e_dist),
        u8(e_ext),
        i32(mate),
        i32(order),
        ctypes.c_int64(order.size),
        ctypes.c_int64(max_distance),
        ctypes.c_int64(max_nodes),
        ctypes.c_int64(insert_delta),
        ctypes.c_int64(threads if threads > 0 else (os.cpu_count() or 2)),
        ctypes.byref(out_ptr),
    )
    try:
        rows = np.ctypeslib.as_array(out_ptr, shape=(int(n), 5)).copy() if n else np.zeros((0, 5), dtype=np.int64)
    finally:
        lib.siga_paired_free(out_ptr)
    return rows
