"""Device FM-index pair plane and the stage-A pair scan, on PyTorch.

Port of the pair-step path of `siga_tpu/ops/fm_device.py`.  An FM-index
lives on the device as its pair plane: one 57-column int32 row per
128-symbol BWT block (cur and prev 2-bit symbol words, their '$' masks in
even-bit format, and 25 exclusive pair checkpoints), plus the 5x5 closure K
with K[c2][c1] = C(c2) + occ_c2(C(c1) - 1), so that two backward-search
steps are one row read:  lo'' = K[c2][c1] + occ2((c2, c1), lo - 1).

The plane build (`build_pair_plane`) is the hand-written CUDA kernel K2
(`csrc/pair_plane.cu`) and the scan (`scan_pair`) the kernel K1
(`csrc/scan_pair.cu`) on a CUDA tensor; each runs its plain PyTorch
version (`build_pair_plane_plain`, `scan_pair_plain`) on a CPU tensor.  K1
writes each lane's emitted rows into a slab of its own in one pass.  A scan
on the card is a `CardScan` with two finishing halves: `outputs()` reads the
sizes and compacts exactly (`compact_slab`, `scan_in_parts`: the plain
version's order), `pack()` compacts into a budget on the stream and packs
every output into one buffer, so that `DualScanner.dispatch` never waits on
the card and `DualScanner.collect` waits once a chunk; on a CPU tensor a
`PlainScan` of the plain version's outputs has the same halves.
The plain helpers below work in int64 with explicit 32-bit masks: PyTorch
has no popcount and no shifts on uint32.

`DualScanner` also runs the JAX package's other route, selected by
SIGA_PAIR_STEP=0: the single-step scan (`scan_single`, the CUDA kernel K3,
`csrc/scan_single.cu`, on a CUDA tensor; `scan_single_plain` on a CPU
tensor), port of `_scan_packed_core`, one backward-search step a symbol
over the single-step plane (`single_step_plane_host`, one 16-column row a
block).  It gives the pair scan's output tuple, so `CardScan` and
`DualScanner.collect` serve both routes; there a lane emits at most one
block a step, and trel counts from t0 = p1 instead of 2 * (p1 // 2).

`DualScanner(..., devices=D devices)` is the JAX package's index-sharded
capacity mode (`shard_index=True` there): the stacked single-step plane split
by rows over the devices (`shard_plane`), scanned by `scan_single_sharded`
(K3 reading each row through a table of the shards, on a CUDA tensor;
`scan_single_sharded_plain`, whose occ is `occ_single_sharded`, on a CPU
tensor).

`scan_stage_a` is the JAX package's `_scan_stage_a`, the stage-A scan with
'$'-probes that only its compile check and dry run call (the port's are
`dryrun.entry` and `dryrun.stage_a_step`): the CUDA kernel K9
(`csrc/stage_a.cu`) on a CUDA tensor, `scan_stage_a_plain` on a CPU tensor;
it emits every step's state un-compacted, over a single-step plane of any
row count.
"""
from __future__ import annotations

import ctypes
import functools
import os
from typing import Sequence

import numpy as np
import torch

from ..index.fm import SAMPLE, FMIndex

from .. import kernels
from ..device import native_lib
from ..parallel.dist import device_list

PAIR_COLS = 57  # 8 cur + 8 prev + 8 cur$ + 8 prev$ + 25 ckpt (sample=128)
SINGLE_COLS = 16  # 8 symbol words + 4 '$' words + A, C, G, T ckpt (sample=128)
_LO_BITS = 0x55555555
_U32 = 0xFFFFFFFF

# Lane-group transform ids: how a lane's scan sequence derives from the read.
GROUP_ID = 0    # seq itself (suffix search in the forward index)
GROUP_RC = 1    # reverse_complement(seq) (forward index)
GROUP_REV = 2   # reverse(seq) (reverse index)
GROUP_COMP = 3  # complement(seq) (reverse index)
NON_ACGT = "read contains non-ACGT symbols; run `siga preprocess` first"


def _i32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding 32 bits -> int32 with the same bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 -> int64 holding the same bits as an unsigned value."""
    return x.to(torch.int64) & _U32


class DeviceFM:
    """The occ planes of one FM-index on `device`, each built at its first
    use, as the JAX package does, so a route pays only for the plane it
    reads.

    plane: the pair plane, int32 [nblocks, 57], and K: int32 [5, 5], built
    together by K2; occ_plane: the single-step plane, int32 [nblocks, 16]
    (`single_step_plane_host`); pred: the C array (host int64 [5]);
    pred_dev: the same as int32 on `device`, for the kernels."""

    def __init__(self, host: FMIndex, device):
        self.device = torch.device(device)
        self.length = host.length
        self.nblocks = host.length // SAMPLE + 1
        self.pred = np.asarray(host.pred, dtype=np.int64)
        self.pred_dev = torch.as_tensor(self.pred, dtype=torch.int32, device=self.device)
        self._host = host
        self._pair = None
        self._occ_plane = None

    def _built(self, name: str):
        if self._host is None:
            raise ValueError(f"no {name}: adopted without it")
        return self._host

    @property
    def plane(self) -> torch.Tensor:
        return self._pair_plane()[0]

    @property
    def K(self) -> torch.Tensor:
        return self._pair_plane()[1]

    def _pair_plane(self):
        if self._pair is None:
            codes = torch.from_numpy(np.ascontiguousarray(self._built("pair plane").codes))
            self._pair = build_pair_plane(codes.to(self.device), self.pred, self.nblocks)
        return self._pair

    @property
    def occ_plane(self) -> torch.Tensor:
        if self._occ_plane is None:
            host = self._built("single-step plane")
            self._occ_plane = torch.from_numpy(single_step_plane_host(host)).to(self.device)
        return self._occ_plane

    def single_step_rows(self) -> torch.Tensor:
        """The single-step plane without building it on `device`: packed on
        the host (a CPU tensor), or the adopted one where there is no host
        index (`from_jax_state`)."""
        if self._host is None:
            return self.occ_plane
        return torch.from_numpy(single_step_plane_host(self._host))

    @classmethod
    def from_jax_state(cls, plane, K, pred, length: int, nblocks: int, device, occ_plane=None):
        """Adopt the JAX package's pair plane and K (numpy arrays, as from
        `siga_tpu.ops.fm_device.DeviceFM.pair_plane_device()`) and, when
        given, its single-step plane (`DeviceFM.occ_plane`)."""
        shapes = {"plane": (plane, PAIR_COLS), "occ_plane": (occ_plane, SINGLE_COLS)}
        for name, (x, cols) in shapes.items():
            if x is not None and np.shape(x) != (nblocks, cols):
                raise ValueError(f"{name} shape {np.shape(x)} != ({nblocks}, {cols})")
        self = cls.__new__(cls)
        self.device = torch.device(device)
        self.length = int(length)
        self.nblocks = int(nblocks)
        self.pred = np.asarray(pred, dtype=np.int64)
        self.pred_dev = torch.as_tensor(self.pred, dtype=torch.int32, device=self.device)
        self._host = None

        def adopt(x):
            return torch.from_numpy(np.asarray(x).astype(np.int32)).to(self.device)

        self._pair = (adopt(plane), adopt(K))
        self._occ_plane = None if occ_plane is None else adopt(occ_plane)
        return self


def single_step_plane_host(host: FMIndex) -> np.ndarray:
    """The single-step occ plane of `host`, int32 [nblocks, 16] (a 64-byte
    row a 128-symbol block): 8 words of 2-bit symbols (word j holds symbols
    [16j, 16j + 16), low bits first; '$' and the padding past n pack as A),
    4 words of the '$' mask (one bit a symbol), then the exclusive A, C, G, T
    checkpoints.  There is no '$' checkpoint: base_$ = block * 128 - sum of
    the four.  Port of `siga_tpu/ops/fm_device.py::DeviceFM._pack_single_step`
    and `occ_plane` (sample 128), in numpy on the host as there."""
    n = host.length
    nblocks = n // SAMPLE + 1
    padded = np.zeros(nblocks * SAMPLE, dtype=np.uint8)
    padded[:n] = host.codes
    sym = padded.reshape(nblocks, SAMPLE).astype(np.uint32)
    two_bit = np.where(sym == 0, 0, sym - 1)  # $->0(A), A..T -> 0..3
    shifts16 = (2 * np.arange(16, dtype=np.uint32))[None, None, :]
    words = (two_bit.reshape(nblocks, SAMPLE // 16, 16) << shifts16).sum(axis=2, dtype=np.uint32)
    dbit = (sym == 0).astype(np.uint32)
    shifts32 = np.arange(32, dtype=np.uint32)[None, None, :]
    dollar = (dbit.reshape(nblocks, SAMPLE // 32, 32) << shifts32).sum(axis=2, dtype=np.uint32)
    ckpt = np.asarray(host.checkpoints, dtype=np.int32)[:, 1:]
    return np.ascontiguousarray(
        np.concatenate([words.view(np.int32), dollar.view(np.int32), ckpt], axis=1)
    )


def pair_plane_host(host: FMIndex):
    """The pair plane and K packed on the host by the C++ runtime
    (`siga_pack_pair_plane`): an implementation independent of
    `build_pair_plane`, to check it against.  Returns (plane int32
    [nblocks, 57], K int64 [5, 5])."""
    lib = native_lib()
    codes = np.ascontiguousarray(host.codes, dtype=np.uint8)
    plane = np.empty((codes.size // SAMPLE + 1, PAIR_COLS), dtype=np.int32)
    K = np.empty(25, dtype=np.int64)
    lib.siga_pack_pair_plane.restype = None
    lib.siga_pack_pair_plane(
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(codes.size),
        plane.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        K.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return plane, K.reshape(5, 5)


def build_pair_plane_plain(codes: torch.Tensor, pred: np.ndarray, nblocks: int):
    """Pair plane and K from the BWT codes (uint8 [n]) in plain tensor ops:
    the reference for the CUDA kernel K2 and the path `build_pair_plane`
    takes on the CPU.

    Port of the XLA program `siga_tpu/ops/fm_device.py::_build_pair_plane_dev`.
    prev at BWT row r is codes[LF(r)] (0 for '$' rows and the padding past
    n, which also counts as '$' in the masks)."""
    dev = codes.device
    n = codes.numel()
    n_pad = nblocks * SAMPLE
    c = torch.zeros(n_pad, dtype=torch.int64, device=dev)
    c[:n] = codes
    pred_t = torch.as_tensor(pred, dtype=torch.int64, device=dev)
    posn = torch.arange(n_pad, device=dev)
    valid = posn < n

    # LF by per-symbol exclusive ordinals (the padding sits past every real row)
    lf = torch.zeros(n_pad, dtype=torch.int64, device=dev)
    for s in range(5):
        is_s = c == s
        ordinal = torch.cumsum(is_s, 0) - is_s.to(torch.int64)
        lf = torch.where(is_s, pred_t[s] + ordinal, lf)
    prev = c[lf.clamp(0, n_pad - 1)]
    prev = torch.where((c == 0) | ~valid, 0, prev)

    shifts = 2 * torch.arange(16, device=dev)

    def even_words(bits2):  # [n_pad] 2-bit values -> [nblocks, 8] int32 words
        return _i32((bits2.view(nblocks, 8, 16) << shifts).sum(2))

    key = torch.where(valid, prev * 5 + c, 25)
    per_block = torch.bincount(
        (posn // SAMPLE) * 26 + key, minlength=nblocks * 26
    ).view(nblocks, 26)[:, :25]
    ckpt = torch.cumsum(per_block, 0) - per_block
    plane = torch.cat(
        [
            even_words((c - 1).clamp(min=0)),
            even_words((prev - 1).clamp(min=0)),
            even_words((c == 0).to(torch.int64)),
            even_words((prev == 0).to(torch.int64)),
            ckpt.to(torch.int32),
        ],
        dim=1,
    ).contiguous()
    # K[c2][c1] = C(c2) + occ_c2(C(c1) - 1)
    K = pred_t[:, None] + torch.stack(
        [torch.bincount(c[: int(pred[c1])], minlength=5) for c1 in range(5)], dim=1
    )
    return plane, K.to(torch.int32).contiguous()


MAX_PLANE_CODES = 2**31 - SAMPLE  # n_pad = (n // 128 + 1) * 128 stays an int32


def build_pair_plane(codes: torch.Tensor, pred, nblocks: int):
    """The pair plane (int32 [nblocks, 57]) and K (int32 [5, 5]) of the BWT
    codes (uint8 [n]) with C array `pred` and nblocks = n // 128 + 1: the
    CUDA kernel K2 (`csrc/pair_plane.cu`, one launch after a memset of its
    look-back flags, counted as one) on a CUDA tensor, `build_pair_plane_plain`
    on a CPU tensor; any other device raises, as does a failed build or
    launch."""
    pred = np.asarray(pred, dtype=np.int64)
    n = codes.numel()
    if n >= MAX_PLANE_CODES:
        raise ValueError(f"codes: {n} rows, the plane build takes fewer than {MAX_PLANE_CODES}")
    if codes.dtype != torch.uint8 or codes.dim() != 1 or not codes.is_contiguous():
        raise ValueError("codes: want a contiguous 1-d uint8 tensor")
    if nblocks != n // SAMPLE + 1:
        raise ValueError(f"nblocks {nblocks} != {n} // {SAMPLE} + 1")
    if pred.shape != (5,) or pred[0] != 0 or (np.diff(pred) < 0).any() or pred[4] > n:
        raise ValueError(f"pred {pred.tolist()}: want a C array of 5 non-decreasing values in [0, {n}] from 0")
    dev = codes.device
    if dev.type == "cpu":
        return build_pair_plane_plain(codes, pred, nblocks)
    if dev.type != "cuda":
        raise ValueError(f"build_pair_plane: unsupported device {dev}")
    if codes.data_ptr() % 16:
        raise ValueError("codes: want a 16-byte aligned tensor")
    lib = kernels.lib()
    plane = torch.empty((nblocks, PAIR_COLS), dtype=torch.int32, device=dev)
    K = torch.empty((5, 5), dtype=torch.int32, device=dev)
    scratch = torch.empty(lib.siga_pair_plane_scratch(nblocks), dtype=torch.int32, device=dev)
    kernels.launch(
        "pair_plane", dev, lib.siga_pair_plane,
        codes.data_ptr(), n, nblocks, *(int(p) for p in pred),
        plane.data_ptr(), K.data_ptr(), scratch.data_ptr(),
    )
    return plane, K


def _popcount(x: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of int64 values below 2**32."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _U32) >> 24


def _popsum(mask: torch.Tensor) -> torch.Tensor:
    return _popcount(mask).sum(dim=0)


def _match2(w, pattern: int):
    x = w ^ pattern
    return ~(x | (x >> 1)) & _LO_BITS


def _pair_masks(rowsT: torch.Tensor, want_prev: bool):
    """Even-bit match masks of each symbol from gathered pair-plane rows
    (rowsT: int64 [57, R]).  Returns (cur[5], prev[5] or None), each mask
    [8, R] with bit 2k set iff symbol k of the word matches."""

    def masks(w, d):
        w, d = _u32(w), _u32(d)
        return (
            d,
            _match2(w, 0) & ~d,
            _match2(w, _LO_BITS),
            _match2(w, 0xAAAAAAAA),
            _match2(w, _U32),
        )

    cur = masks(rowsT[0:8], rowsT[16:24])
    prev = masks(rowsT[8:16], rowsT[24:32]) if want_prev else None
    return cur, prev


def _tail_wmask(tail: torch.Tensor) -> torch.Tensor:
    """[8, R] valid-position mask (2 bits a symbol, low first)."""
    widx = (torch.arange(8, device=tail.device) * 16)[:, None]
    valid = (tail[None, :] - widx).clamp(0, 16)
    return torch.where(valid == 16, _U32, (torch.ones_like(valid) << (2 * valid)) - 1)


def _pair_occ(rowsT, tail, c1, want_pairs: bool):
    """Inclusive occ counts from gathered pair-plane rows: rowsT int64
    [57, R], tail [R], c1 [R] (the first prepended symbol).  Returns
    (singles [5, R], pairs [5, R] or None), pairs[p] = occ2((p, c1), i)."""
    ckpt = rowsT[32:57]
    cur, prev = _pair_masks(rowsT, want_pairs)
    wmask = _tail_wmask(tail)
    singles = torch.stack(
        [
            ckpt[c] + ckpt[5 + c] + ckpt[10 + c] + ckpt[15 + c] + ckpt[20 + c]
            + _popsum(cur[c] & wmask)
            for c in range(5)
        ]
    )
    if not want_pairs:
        return singles, None
    # the c1 == 0 case only occurs on lanes whose step is masked
    m_c1 = torch.zeros_like(cur[1])
    for c in range(1, 5):
        m_c1 = torch.where(c1[None, :] == c, cur[c], m_c1)
    pairs = []
    for p in range(5):
        base = torch.zeros_like(c1)
        for c in range(1, 5):
            base = torch.where(c1 == c, ckpt[p * 5 + c], base)
        pairs.append(base + _popsum(prev[p] & m_c1 & wmask))
    return singles, torch.stack(pairs)


def _sel_rank(vec5, c):
    """vec5 [5, Q] selected by rank c [Q] -> [Q]."""
    return vec5.gather(0, c[None, :])[0]


def _below_rank(vec5, c):
    """Sum of vec5[r] for r < c, per lane."""
    r = torch.arange(5, device=c.device)[:, None]
    return torch.where(r < c[None, :], vec5, 0).sum(dim=0)


def _update_left(rlo, c, l_c, u_c, pred64):
    """IntervalPair.updateL of rank c [Q] in 0..4 with the inclusive occ
    counts [5, Q] at lo - 1 and hi: the new (lo, hi, rlo, rhi).  As
    `siga_tpu/ops/fm_device.py::_update_left_T`."""
    diff = u_c - l_c
    nrlo = rlo + _below_rank(diff, c)
    return (_sel_rank(pred64[:, None] + l_c, c), _sel_rank(pred64[:, None] + u_c, c) - 1,
            nrlo, nrlo + _sel_rank(diff, c) - 1)


def _unpack_2bit(words: torch.Tensor, lens: torch.Tensor, maxlen: int):
    """(n, maxlen//16) packed 2-bit words -> (n, maxlen) int64 ranks 1..4,
    0 outside the read span."""
    j = torch.arange(maxlen, device=words.device)
    sym = ((_u32(words).repeat_interleave(16, dim=1) >> (2 * (j % 16))) & 3) + 1
    return torch.where(j[None, :] < lens[:, None], sym, 0)


def _complement_ranks(c):
    # A<->T, C<->G on ranks 1..4; '$'/pad (0) unchanged
    return torch.where(c == 0, 0, 5 - c)


def _pack_bits32(flags: torch.Tensor) -> torch.Tensor:
    """bool [L] -> int32 words [ceil(L/32)] (bit j of word w = flags[32w+j])."""
    L = flags.numel()
    nw = -(-L // 32)
    pad = torch.zeros(nw * 32, dtype=torch.int64, device=flags.device)
    pad[:L] = flags
    j = torch.arange(32, device=flags.device)
    return _i32((pad.view(nw, 32) << j).sum(dim=1))


def _unpack_bits32(words: torch.Tensor, L: int) -> torch.Tensor:
    j = torch.arange(32, device=words.device)
    return ((words.to(torch.int64)[:, None] >> j) & 1).reshape(-1)[:L].bool()


def _lane_chars(la_words, lens, groups: Sequence[int]):
    """charsT int64 [maxlen, lanes]: charsT[t] is the symbol each lane
    prepends at step t, s'[l-2-t] of its transformed read, and
    charsT[maxlen-1] its first symbol s'[l-1].  With ra the right-aligned
    read:  identity = roll(flip(ra), -1), rc = comp(roll(la, -1)),
    reverse = roll(la, -1), complement = comp(roll(flip(ra), -1))."""
    maxlen = la_words.shape[1] * 16
    la = _unpack_2bit(la_words, lens, maxlen)
    j = torch.arange(maxlen, device=la.device)[None, :]
    src = j - (maxlen - lens)[:, None]
    ra = torch.where(src >= 0, la.gather(1, src.clamp(0, maxlen - 1)), 0)
    rra_roll = torch.roll(torch.flip(ra, dims=[1]), -1, dims=1)
    la_roll = torch.roll(la, -1, dims=1)
    group_chars = {
        GROUP_ID: lambda: rra_roll,
        GROUP_RC: lambda: _complement_ranks(la_roll),
        GROUP_REV: lambda: la_roll,
        GROUP_COMP: lambda: _complement_ranks(rra_roll),
    }
    return torch.cat([group_chars[g]() for g in groups], dim=0).T


def scan_lanes(la_words, lens, nblocks: int, fwd_groups, rev_groups):
    """The plain scans' lanes (the forward groups first, then the reverse
    groups, each with stride n): (charsT int64 [maxlen, lanes] as
    `_lane_chars` gives it, each lane's read length, whether it scans the
    forward index, and its table's first row in the stacked plane)."""
    groups = tuple(fwd_groups) + tuple(rev_groups)
    lens64 = lens.to(torch.int64)
    charsT = _lane_chars(la_words, lens64, groups)
    is_fwd = torch.arange(charsT.shape[1], device=lens.device) < la_words.shape[0] * len(fwd_groups)
    return charsT, lens64.repeat(len(groups)), is_fwd, torch.where(is_fwd, 0, nblocks)


def _scan_params(lim_t: int, min_overlap: int):
    """(p1, t0): the first step that may emit, and the first step of the
    emitting supersteps (even)."""
    p1 = min(max(min_overlap - 1, 0), lim_t)
    return p1, 2 * (p1 // 2)


def scan_pair_plain(
    plane2, K2, pred, length: int, nblocks: int, la_words, lens,
    lim_t: int, min_overlap: int, fwd_groups, rev_groups,
):
    """Stage-A scan, pair-step engine, in plain PyTorch: the reference for
    the CUDA kernel K1 and the path `scan_pair` takes on the CPU.

    Mirrors `siga_tpu/ops/fm_device.py::_scan_pair_core`.  Inputs: the
    stacked [2*nblocks, 57] plane (forward rows, then reverse rows), K2
    int32 [2, 5, 5], pred int32 [5], the reads as left-aligned 2-bit words
    la_words int32 [n, maxlen/16] and lens int32 [n].  Lanes: the forward
    groups first, then the reverse groups, each with stride n.  Outputs
    (int32 tensors, sized exactly):
      counts [2] = [emitted blocks, containment candidates]
      lane_counts [lanes]
      data3T [3, blocks] = lo | rlo | size   (lane-major, t ascending)
      trel [blocks]                          (t - t0, t0 = 2*(p1//2))
      candmask [ceil(lanes/32)]
      candT [5, candidates] = flo | frlo | l0 | fsize | psize
      subwords [ceil(lanes/32)]
    """
    dev = plane2.device
    charsT, lens_all, is_fwd, tab = scan_lanes(la_words, lens, nblocks, fwd_groups, rev_groups)
    max_t = charsT.shape[0] - 1
    L = charsT.shape[1]
    tab2 = torch.cat([tab, tab])
    pred64 = pred.to(torch.int64)
    K_flat = K2.to(torch.int64).reshape(-1)
    k_base = torch.where(is_fwd, 0, 25)

    def occ(i, tabs, c1=None):
        pos = i + 1
        block0 = torch.div(pos, SAMPLE, rounding_mode="floor")
        rows = plane2[(block0 + tabs).clamp(0, 2 * nblocks - 1)]
        return _pair_occ(rows.T.to(torch.int64), pos - block0 * SAMPLE, c1, c1 is not None)

    c0 = charsT[max_t]
    lo = pred64[c0]
    full, _ = occ(torch.full((L,), length - 1, device=dev), tab)
    hi = lo + _sel_rank(full, c0) - 1
    rlo, rhi = lo, hi

    p1, t0 = _scan_params(lim_t, min_overlap)
    emitted, valids = [], []
    zeros = torch.zeros(L, dtype=torch.int64, device=dev)
    for st in range((lim_t + 1) // 2):  # odd lim_t: a masked phantom half-step
        t = 2 * st
        c1 = charsT[t]
        c2 = charsT[t + 1] if t + 1 < lim_t else zeros
        singles, pairs = occ(torch.cat([lo - 1, hi]), tab2, torch.cat([c1, c1]))
        l_s, u_s = singles[:, :L], singles[:, L:]
        l_p, u_p = pairs[:, :L], pairs[:, L:]
        diff = u_s - l_s
        pd = u_p - l_p
        active1 = t <= lens_all - 2
        active2 = t + 1 <= lens_all - 2
        # sub-state 1 (prepend c1)
        d1 = _sel_rank(diff, c1)
        nlo1 = _sel_rank(pred64[:, None] + l_s, c1)
        nhi1 = _sel_rank(pred64[:, None] + u_s, c1) - 1
        nrlo1 = rlo + _below_rank(diff, c1)
        nrhi1 = nrlo1 + d1 - 1
        # state 2 (prepend c2): two-step closed form via K + pair occ
        kv = torch.where(
            (c1 > 0) & (c2 > 0), K_flat[k_base + c2 * 5 + c1], 0
        )
        nlo2 = kv + _sel_rank(l_p, c2)
        nhi2 = kv + _sel_rank(u_p, c2) - 1
        d2 = _sel_rank(pd, c2)
        nrlo2 = nrlo1 + _below_rank(pd, c2)
        nrhi2 = nrlo2 + d2 - 1
        if t + 1 >= p1:
            # '$'-probe blocks at state t (psize from the cur-'$' singles)
            # and at state t+1 (psize from the ('$', c1) pair count)
            psize0 = diff[0]
            valid0 = (psize0 > 0) & (rlo + psize0 - 1 >= 0) & active1 & (t >= p1)
            psize1 = pd[0]
            valid1 = (psize1 > 0) & (nrlo1 + psize1 - 1 >= 0) & active2
            emitted.append(
                torch.stack(
                    [
                        torch.stack([lo, rlo, hi - lo, zeros + (t - t0)], dim=1),
                        torch.stack([nlo1, nrlo1, d1 - 1, zeros + (t + 1 - t0)], dim=1),
                    ],
                    dim=1,
                )
            )  # [L, 2, 4]
            valids.append(torch.stack([valid0, valid1], dim=1))  # [L, 2]

        def step(s0, s1, s2):
            return torch.where(active2, s2, torch.where(active1, s1, s0))

        lo, hi, rlo, rhi = (
            step(lo, nlo1, nlo2),
            step(hi, nhi1, nhi2),
            step(rlo, nrlo1, nrlo2),
            step(rhi, nrhi1, nrhi2),
        )

    return finish_scan(
        emitted, valids, lambda i, tabs: occ(i, tabs)[0], lo, hi, rlo, rhi, tab, nblocks
    )


def finish_scan(emitted, valids, singles, lo, hi, rlo, rhi, tab, nblocks: int):
    """The plain scans' outputs from their per-step emissions (emitted: a
    list of int64 [L, k, 4] rows [lo, rlo, size, trel], valids: of bool [L,
    k], in step order) and the final intervals: the finals classify each
    lane's full-length interval, its left extensions from the lane's own
    table (rows from `tab`), its right extensions from the other table.
    `singles(i, tabs)` gives the inclusive occ counts [5, Q] of positions i
    in the tables at tabs."""
    L = lo.numel()
    dev = lo.device
    if emitted:
        valid = torch.cat(valids, dim=1)  # [L, T2], t ascending per lane
        emit = torch.cat(emitted, dim=1)[valid]  # [blocks, 4], lane-major
        lane_counts = valid.sum(dim=1)
    else:
        emit = torch.zeros((0, 4), dtype=torch.int64, device=dev)
        lane_counts = torch.zeros(L, dtype=torch.int64, device=dev)

    fs = singles(torch.cat([lo - 1, hi]), torch.cat([tab, tab]))
    l_c, u_c = fs[:, :L], fs[:, L:]
    lext_dna = (u_c[1:] - l_c[1:]).sum(dim=0) > 0
    other = nblocks - tab
    fr = singles(torch.cat([rlo - 1, rhi]), torch.cat([other, other]))
    rext_dna = (fr[1:, L:] - fr[1:, :L]).sum(dim=0) > 0
    l0, u0 = l_c[0], u_c[0]
    psize_f = u0 - l0
    fvalid = (
        (psize_f > 0) & (u0 - 1 >= 0) & (rlo + psize_f - 1 >= 0)
        & (rlo + psize_f - 1 >= rlo)
    )
    candT = torch.stack([lo, rlo, l0, hi - lo, psize_f])[:, fvalid]
    counts = torch.tensor([emit.shape[0], candT.shape[1]], dtype=torch.int32, device=dev)
    i32 = torch.int32
    return (
        counts,
        lane_counts.to(i32),
        emit[:, :3].T.to(i32),
        emit[:, 3].to(i32),
        _pack_bits32(fvalid),
        candT.to(i32),
        _pack_bits32(lext_dna | rext_dna),
    )


def _check_lane_inputs(dev, pred, la_words, lens, more=()):
    """pred, la_words, lens and the (name, tensor, shape) of `more`, each a
    contiguous int32 tensor of its shape on `dev`."""
    inputs = [
        ("pred", pred, (5,)),
        ("la_words", la_words, None),
        ("lens", lens, (la_words.shape[0],)),
        *more,
    ]
    for name, x, shape in inputs:
        if x.device != dev or x.dtype != torch.int32 or not x.is_contiguous():
            raise ValueError(f"{name}: want a contiguous int32 tensor on {dev}")
        if shape is not None and tuple(x.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(x.shape)} != {shape}")


SLAB_ROW_BYTES = 16  # one emitted [lo, rlo, size, trel] int32 row


def emit_cap(lim_t: int, min_overlap: int) -> int:
    """Rows a lane can emit: at most one per step t in [p1, lim_t - 1]."""
    p1, _t0 = _scan_params(lim_t, min_overlap)
    return max(lim_t - p1, 0)


def lane_parts(lanes: int, cap: int, budget_bytes: int):
    """[l0, l1) lane ranges whose slabs of `cap` rows each fit in
    `budget_bytes`: all lanes at once where they fit, else parts whose l0
    is a multiple of 32 (a mask word)."""
    if lanes * cap * SLAB_ROW_BYTES <= budget_bytes:
        return [(0, lanes)]
    per = max(budget_bytes // (cap * SLAB_ROW_BYTES) // 32 * 32, 32)
    return [(l0, min(l0 + per, lanes)) for l0 in range(0, lanes, per)]


def _owners(ends: torch.Tensor, total: int):
    """k = 0 .. total-1 and, for each, the run that holds it, where `ends`
    is the inclusive cumsum of the runs' lengths."""
    k = torch.arange(total, device=ends.device)
    return k, torch.searchsorted(ends, k, right=True)


def compact_slab(slab: torch.Tensor, lane_counts: torch.Tensor, extra=()):
    """The rows of per-lane slabs (int32 [lanes, cap, 4], lane l's first
    lane_counts[l] rows valid) in the scan's output order, lane-major and t
    ascending: [sum(lane_counts), 4], by a cumsum of the counts and one
    gather; raises when a count exceeds the slab.  Also returns the values
    of the 0-d int64 tensors `extra`, read in the same synchronisation as
    the row count."""
    lanes, cap = slab.shape[0], slab.shape[1]
    counts = lane_counts.to(torch.int64)
    ends = torch.cumsum(counts, 0)
    head = [ends[-1], counts.max()] if lanes else [counts.sum(), counts.sum()]
    total, most, *values = torch.stack([*head, *extra]).tolist()
    if most > cap:
        raise RuntimeError(f"scan: a lane emitted {most} rows, its slab holds {cap}")
    # row k of lane l sits at slab row l * cap + (k - start of l); its four
    # words are gathered one by one (torch's gather of [*, 4] int32 rows ran
    # far slower on the H100)
    k, lane = _owners(ends, total)
    row = k + lane * cap - (ends - counts).index_select(0, lane)
    words = row[:, None] * 4 + torch.arange(4, device=slab.device)
    return torch.take(slab, words.reshape(-1)).reshape(-1, 4), values


def scan_in_parts(lanes: int, cap: int, budget_bytes: int, launch, lane_counts, extra=lambda: ()):
    """Scan `lanes` lanes in as many launches as their slabs need:
    `launch(l0, l1)` scans lanes [l0, l1) and returns their slab (it also
    fills lane_counts[l0:l1]).  Returns the compacted rows of all parts, in
    order, and the values of the 0-d tensors that `extra()` gives once every
    part has run (read with the last part's row count)."""
    parts = lane_parts(lanes, cap, budget_bytes)
    rows = []
    for i, (l0, l1) in enumerate(parts):
        last = i == len(parts) - 1
        part, values = compact_slab(launch(l0, l1), lane_counts[l0:l1], extra() if last else ())
        rows.append(part)
    return (torch.cat(rows) if len(rows) > 1 else rows[0]), values


def scan_pair(
    plane2, K2, pred, length: int, nblocks: int, la_words, lens,
    lim_t: int, min_overlap: int, fwd_groups, rev_groups,
    slab_bytes: int | None = None,
):
    """The stage-A pair scan: the CUDA kernel K1 on CUDA tensors,
    `scan_pair_plain` on CPU tensors; same arguments and outputs.

    On CUDA one launch scans all lanes in one pass into per-lane slabs that
    `compact_slab` orders; where the slabs would not fit in `slab_bytes`
    (default a third of the free device memory) the lanes are split over
    several launches of the same kernel.  One synchronisation a launch reads
    the sizes of the outputs (`CardScan.outputs`)."""
    return scan_pair_call(
        plane2, K2, pred, length, nblocks, la_words, lens,
        lim_t, min_overlap, fwd_groups, rev_groups, slab_bytes,
    ).outputs()


def scan_pair_call(
    plane2, K2, pred, length: int, nblocks: int, la_words, lens,
    lim_t: int, min_overlap: int, fwd_groups, rev_groups,
    slab_bytes: int | None = None,
):
    """`scan_pair`'s scan, not yet finished: a `CardScan` of K1 on CUDA
    tensors (nothing launched yet), a `PlainScan` of `scan_pair_plain`'s
    outputs on CPU tensors."""
    dev = plane2.device
    if dev.type == "cpu":
        return PlainScan(scan_pair_plain(
            plane2, K2, pred, length, nblocks, la_words, lens,
            lim_t, min_overlap, fwd_groups, rev_groups,
        ))
    if dev.type != "cuda":
        raise ValueError(f"scan_pair: unsupported device {dev}")
    _check_lane_inputs(dev, pred, la_words, lens,
                       [("plane2", plane2, (2 * nblocks, PAIR_COLS)), ("K2", K2, (2, 5, 5))])
    p1, t0 = _scan_params(lim_t, min_overlap)
    n, wpr = la_words.shape
    groups = tuple(fwd_groups) + tuple(rev_groups)
    entry = functools.partial(
        kernels.lib().siga_scan_pair,
        plane2.data_ptr(), K2.data_ptr(), pred.data_ptr(), la_words.data_ptr(), lens.data_ptr(),
        length, nblocks, n, wpr, len(fwd_groups), _groups_code(groups), lim_t, p1, t0,
        n * len(groups),
    )
    return CardScan("scan_pair", entry, n * len(groups), emit_cap(lim_t, min_overlap), dev,
                    slab_bytes)


def _groups_code(groups) -> int:
    """The lane groups' transform ids, 2 bits each, first group lowest."""
    return sum(g << (2 * k) for k, g in enumerate(groups))


HEADER_WORDS = 4  # a packed scan: rows, the most rows of a lane, candidates, 0


def _packed(header, lane_counts, rows, candmask, candT, subwords) -> torch.Tensor:
    """One int32 buffer of a scan's outputs: the header (0-d tensors), the
    lane counts [L], `rows` [R, 4] rows of [lo, rlo, size, trel], the
    candidate mask, `candT` [5, C] candidate rows and the substring words;
    `unpack_scan` reads it."""
    head = torch.stack([h.to(torch.int64) for h in header])
    head = torch.cat([head, head.new_zeros(HEADER_WORDS - len(header))]).to(torch.int32)
    return torch.cat([head, lane_counts, rows.reshape(-1), candmask, candT.reshape(-1), subwords])


def unpack_scan(buf: np.ndarray, L: int, rows: int, cands: int):
    """The scan outputs of a buffer `pack(rows, cands)` made, for L lanes:
    (total rows, the most rows of a lane, candidates) and the numpy arrays
    (lane_counts, rows [total, 4], candmask, candT [5, candidates],
    subwords); the caller checks first that total <= rows and candidates
    <= cands."""
    total, most, n_cand = (int(v) for v in buf[:3])
    nw = -(-L // 32)
    ends = np.cumsum([HEADER_WORDS, L, 4 * rows, nw, 5 * cands, nw])
    part = [buf[a:b] for a, b in zip(ends[:-1], ends[1:])]
    return (total, most, n_cand), (
        part[0], part[1].reshape(rows, 4)[:total], part[2],
        part[3].reshape(5, cands)[:, :n_cand], part[4],
    )


class PlainScan:
    """A plain version's scan outputs (on the CPU, where they are made at
    once), with `CardScan`'s finish halves."""

    def __init__(self, out):
        self.out = out

    def outputs(self):
        return self.out

    def pack(self, rows: int, cands: int) -> torch.Tensor:
        """`CardScan.pack` of these outputs: the first `rows` rows and
        `cands` candidates, zeros past the outputs."""
        counts, lane_counts, data3T, trel, candmask, candT, subwords = self.out
        emit = torch.cat([data3T.T, trel[:, None]], dim=1)[:rows]
        got = torch.zeros((rows, 4), dtype=torch.int32)
        got[: emit.shape[0]] = emit
        cand = torch.zeros((5, cands), dtype=torch.int32)
        cand[:, : candT.shape[1]] = candT[:, :cands]
        header = (counts[0], lane_counts.max(), counts[1])
        return _packed(header, lane_counts, got, candmask, cand, subwords)


class CardScan:
    """A stage-A scan kernel over L lanes on the card, in two halves:
    `entry(lane_base, nl, cap, lane_counts, fall, candmask, subwords, slab,
    stream)` launches lanes [lane_base, lane_base + nl), each with a slab of
    `cap` rows, and counts as a launch of `name`; the lanes go over as many
    launches as their slabs need to fit in `slab_bytes` (default a third of
    the free device memory, read once).

    `outputs()` launches and finishes at once, as the plain versions return:
    a part's sizes read in one synchronisation, its rows compacted exactly
    (`scan_in_parts`).  `pack(rows, cands)` only enqueues: the launches,
    each part's rows compacted on the stream into a budget of `rows` rows,
    the candidates into `cands`, all in one buffer with the true sizes in
    its header.  Of a one-part scan the slab is held, so a larger budget
    packs again without a launch; a scan of several parts keeps no slab
    and launches again."""

    def __init__(self, name: str, entry, L: int, cap: int, dev, slab_bytes: int | None):
        if L == 0:
            raise ValueError(f"{name}: no lanes")
        self.name, self.entry, self.L, self.cap, self.dev = name, entry, L, cap, dev
        if slab_bytes is None:
            slab_bytes = torch.cuda.mem_get_info(dev)[0] // 3
        self.slab_bytes = slab_bytes
        self.lane_counts = torch.empty(L, dtype=torch.int32, device=dev)
        self.fall = torch.empty((5, L), dtype=torch.int32, device=dev)
        nw = -(-L // 32)
        self.candmask = torch.empty(nw, dtype=torch.int32, device=dev)
        self.subwords = torch.empty(nw, dtype=torch.int32, device=dev)
        self.slab = None  # a one-part scan's slab, once launched

    def _launch(self, l0: int, l1: int) -> torch.Tensor:
        if l0 == 0:  # the kernel ORs bits in
            self.candmask.zero_()
            self.subwords.zero_()
        slab = torch.empty((l1 - l0, self.cap, 4), dtype=torch.int32, device=self.dev)
        kernels.launch(
            self.name, self.dev, self.entry, l0, l1 - l0, self.cap,
            self.lane_counts.data_ptr(), self.fall.data_ptr(), self.candmask.data_ptr(),
            self.subwords.data_ptr(), slab.data_ptr(),
        )
        return slab

    def _cand_ends(self) -> torch.Tensor:
        return torch.cumsum(_unpack_bits32(self.candmask, self.L), 0)

    def outputs(self):
        """The plain versions' output tuple."""
        L = self.L
        cand_ends = []  # the candidate bits' cumsum, once every part has run

        def cand_count():
            cand_ends.append(self._cand_ends())
            return (cand_ends[0][-1],)

        emit, (n_cand,) = scan_in_parts(L, self.cap, self.slab_bytes, self._launch,
                                        self.lane_counts, cand_count)
        candT = self.fall.index_select(1, _owners(cand_ends[0], n_cand)[1])
        counts = torch.stack([self.lane_counts.sum(), cand_ends[0][-1]]).to(torch.int32)
        return (counts, self.lane_counts, emit[:, :3].T, emit[:, 3], self.candmask, candT,
                self.subwords)

    def pack(self, rows: int, cands: int) -> torch.Tensor:
        """Enqueue the scan (unless its slab is held) and one int32 buffer of
        its outputs (`_packed`): the first `rows` rows in the plain order,
        the first `cands` candidates, and in the header the true row count,
        the most rows of a lane and the candidate count.  Nothing waits on
        the card.  rows <= L * cap and cands <= L."""
        L, cap, dev = self.L, self.cap, self.dev
        if self.slab is not None:
            parts = [(0, L, self.slab)]
        else:
            bounds = lane_parts(L, cap, self.slab_bytes)
            parts = ((l0, l1, self._launch(l0, l1)) for l0, l1 in bounds)
        got = torch.zeros((rows, 4), dtype=torch.int32, device=dev)
        k = torch.arange(rows, device=dev)
        for l0, l1, slab in parts:
            whole = (l0, l1) == (0, L)
            if whole:
                self.slab = slab
            if rows == 0:
                continue
            # row k of the output sits in lane `lane`, at slab row (lane -
            # l0) * cap + (k - the rows before that lane); rows of lanes
            # outside [l0, l1) come from their own part
            counts = self.lane_counts[:l1].to(torch.int64)
            ends = torch.cumsum(counts, 0)
            lane = torch.searchsorted(ends, k, right=True).clamp_(max=l1 - 1)
            off = (k - (ends - counts).index_select(0, lane)).clamp_(0, cap - 1)
            row = (lane - l0).clamp_(min=0) * cap + off
            words = torch.take(slab, (row[:, None] * 4 + torch.arange(4, device=dev)).reshape(-1))
            if whole:
                got = words.reshape(rows, 4)
            else:
                mine = (lane >= l0) & (k < ends[-1])
                got = torch.where(mine[:, None], words.reshape(rows, 4), got)
        counts = self.lane_counts.to(torch.int64)
        cand_ends = self._cand_ends()
        owner = torch.searchsorted(cand_ends, torch.arange(cands, device=dev), right=True)
        candT = self.fall.index_select(1, owner.clamp_(max=L - 1))
        header = (counts.sum(), counts.max(), cand_ends[-1])
        return _packed(header, self.lane_counts, got, self.candmask, candT, self.subwords)


_NWORDS = SAMPLE // 16  # single-step plane: symbol words a row
_NDWORDS = SAMPLE // 32  # single-step plane: '$' mask words a row
MAX_SHARDS = 16  # rows of the shard table (csrc/scan_single.cu kMaxShards)


def _single_rows(nrows: int, i: torch.Tensor, tabs: torch.Tensor):
    """(row, block0, tail) of positions i [Q] (>= -1) in the tables of a
    single-step plane of `nrows` rows whose rows start at tabs [Q]: the
    global row that holds each, clamped to the plane (as JAX's gather
    clamps), so that no query reads past it."""
    pos = i + 1
    block0 = torch.div(pos, SAMPLE, rounding_mode="floor")
    return (block0 + tabs).clamp(0, nrows - 1), block0, pos - block0 * SAMPLE


def _occ_from_single_rows(rowsT: torch.Tensor, block0: torch.Tensor, tail: torch.Tensor):
    """Inclusive occ counts int64 [5, Q] from gathered single-step rows
    (rowsT int64 [16, Q]): popcounts of the symbol words below the
    position, the A count less the '$' bits (which pack as A), and base_$ =
    block * 128 - the ACGT checkpoints.  Port of `_occ_from_rows`."""
    w = rowsT[:_NWORDS] & _U32
    d = rowsT[_NWORDS : _NWORDS + _NDWORDS] & _U32
    base_acgt = rowsT[_NWORDS + _NDWORDS :]
    wmask = _tail_wmask(tail)
    word0 = (torch.arange(_NDWORDS, device=tail.device) * 32)[:, None]
    dvalid = (tail[None, :] - word0).clamp(0, 32)
    dmask = torch.where(dvalid == 32, _U32, (torch.ones_like(dvalid) << dvalid) - 1)
    n_dollar = _popsum(d & dmask)
    acgt = [_popsum(_match2(w, p) & wmask) for p in (0, _LO_BITS, 0xAAAAAAAA, _U32)]
    acgt[0] = acgt[0] - n_dollar  # '$' packs as A
    base_dollar = block0 * SAMPLE - base_acgt.sum(dim=0)
    return torch.stack([base_dollar + n_dollar] + [base_acgt[k] + acgt[k] for k in range(4)])


def occ_single(plane2: torch.Tensor, nblocks: int, i: torch.Tensor, tabs: torch.Tensor):
    """Inclusive occ counts int64 [5, Q] of positions i [Q] (>= -1), each in
    the table of the stacked single-step plane (int32 [2 * nblocks, 16])
    whose rows start at tabs [Q].  Port of `occ_all_fused_T`.  Position 0
    (i = -1) reads no bit: all zero."""
    row, block0, tail = _single_rows(2 * nblocks, i, tabs)
    return _occ_from_single_rows(plane2[row].T.to(torch.int64), block0, tail)


def shard_rows(nblocks: int, d: int) -> int:
    """Rows a shard holds when the stacked single-step plane (2 * nblocks
    rows) is split into d contiguous row ranges: ceil(2 * nblocks / d); the
    last shards hold fewer, or none."""
    return -(-2 * nblocks // d)


def shard_plane(stacked: torch.Tensor, devices) -> list:
    """The stacked single-step plane (int32 [2 * nblocks, 16], on the host or
    one device) cut into len(devices) contiguous row ranges of
    `shard_rows` rows, range k copied into an allocation of its own on
    devices[k]."""
    bps = shard_rows(stacked.shape[0] // 2, len(devices))
    shards = []
    for k, device in enumerate(devices):
        part = stacked[k * bps : (k + 1) * bps]
        shards.append(torch.empty(part.shape, dtype=torch.int32, device=device).copy_(part))
    return shards


def occ_single_sharded(shards, nblocks: int, i: torch.Tensor, tabs: torch.Tensor):
    """`occ_single` over the stacked single-step plane split into row shards
    (`shard_plane`): each shard counts the queries whose global row it holds
    and 0 for the others, on its own device; the answers are moved to i's
    device and summed.  Port of `occ_all_fused_sharded_T`, whose psum over
    the mesh the sum is.  The global row is clamped first, so no shard reads
    past the plane and a short or empty last shard needs no padding."""
    row, block0, tail = _single_rows(2 * nblocks, i, tabs)
    bps = shard_rows(nblocks, len(shards))
    total = torch.zeros((5, i.numel()), dtype=torch.int64, device=i.device)
    for k, shard in enumerate(shards):
        if shard.shape[0] == 0:  # past the plane: owns no row
            continue
        dev = shard.device
        local = (row - k * bps).clamp(0, shard.shape[0] - 1).to(dev)
        counts = _occ_from_single_rows(shard[local].T.to(torch.int64), block0.to(dev), tail.to(dev))
        total += torch.where((row // bps == k)[None, :], counts.to(i.device), 0)
    return total


def scan_single_plain(
    plane2, pred, length: int, nblocks: int, la_words, lens,
    lim_t: int, min_overlap: int, fwd_groups, rev_groups,
):
    """Stage-A scan, single-step engine, in plain PyTorch: the reference for
    the CUDA kernel K3 and the path `scan_single` takes on the CPU.

    Mirrors `siga_tpu/ops/fm_device.py::_scan_packed_core`: steps t <
    p1 = min(max(min_overlap - 1, 0), lim_t) only update the intervals, the
    steps t in [p1, lim_t) also emit the closed-form '$'-probe block of the
    state before the step ([lo, rlo, size] where occ_$ grows over [lo, hi]);
    a lane's steps with t > len - 2 change nothing.  Inputs as
    `scan_pair_plain`'s, with the stacked [2*nblocks, 16] single-step plane
    and no K2; outputs as its, with trel = t - p1."""
    return _scan_single_steps(
        functools.partial(occ_single, plane2, nblocks), pred, length, nblocks,
        la_words, lens, lim_t, min_overlap, fwd_groups, rev_groups,
    )


def scan_single_sharded_plain(
    shards, pred, length: int, nblocks: int, la_words, lens,
    lim_t: int, min_overlap: int, fwd_groups, rev_groups,
):
    """`scan_single_plain` over the stacked single-step plane split into row
    shards (`shard_plane`), its occ counts from `occ_single_sharded`: the
    reference for the CUDA kernel behind `scan_single_sharded` and the path
    it takes on the CPU.  Port of `_build_sharded_scan` (`_scan_packed_core`
    under shard_map, one psum a step).  The lanes, pred and the outputs are
    on la_words' device."""
    return _scan_single_steps(
        functools.partial(occ_single_sharded, shards, nblocks), pred, length, nblocks,
        la_words, lens, lim_t, min_overlap, fwd_groups, rev_groups,
    )


def _scan_single_steps(
    occ, pred, length: int, nblocks: int, la_words, lens,
    lim_t: int, min_overlap: int, fwd_groups, rev_groups,
):
    """The single-step scan of `scan_single_plain`, its occ counts from
    `occ(i, tabs)` (inclusive, int64 [5, Q])."""
    dev = la_words.device
    charsT, lens_all, _is_fwd, tab = scan_lanes(la_words, lens, nblocks, fwd_groups, rev_groups)
    L = charsT.shape[1]
    tab2 = torch.cat([tab, tab])
    pred64 = pred.to(torch.int64)

    c0 = charsT[-1]  # the lane's first symbol s'[l-1]
    lo = pred64[c0]
    hi = lo + _sel_rank(occ(torch.full((L,), length - 1, device=dev), tab), c0) - 1
    rlo, rhi = lo, hi
    p1, _t0 = _scan_params(lim_t, min_overlap)
    emitted, valids = [], []
    zeros = torch.zeros(L, dtype=torch.int64, device=dev)
    for t in range(lim_t):
        c = charsT[t]
        both = occ(torch.cat([lo - 1, hi]), tab2)
        l_c, u_c = both[:, :L], both[:, L:]
        diff = u_c - l_c
        active = t <= lens_all - 2
        if t >= p1:
            psize = diff[0]
            valids.append(((psize > 0) & (rlo + psize - 1 >= 0) & active)[:, None])
            emitted.append(torch.stack([lo, rlo, hi - lo, zeros + (t - p1)], dim=1)[:, None])
        nlo, nhi, nrlo, nrhi = _update_left(rlo, c, l_c, u_c, pred64)
        lo, hi, rlo, rhi = (
            torch.where(active, new, old)
            for new, old in ((nlo, lo), (nhi, hi), (nrlo, rlo), (nrhi, rhi))
        )
    return finish_scan(emitted, valids, occ, lo, hi, rlo, rhi, tab, nblocks)


def scan_single(
    plane2, pred, length: int, nblocks: int, la_words, lens,
    lim_t: int, min_overlap: int, fwd_groups, rev_groups,
    slab_bytes: int | None = None,
):
    """The single-step stage-A scan: the CUDA kernel K3 on CUDA tensors,
    `scan_single_plain` on CPU tensors; same arguments and outputs.  On CUDA
    one launch scans all lanes in one pass into per-lane slabs, split over
    several launches where the slabs would not fit in `slab_bytes` (default
    a third of the free device memory), as `scan_pair` does.  It is
    `scan_single_sharded` with the whole plane as its one shard."""
    return scan_single_sharded(
        [plane2], pred, length, nblocks, la_words, lens,
        lim_t, min_overlap, fwd_groups, rev_groups, slab_bytes,
    )


def _check_shards(shards, nblocks: int) -> int:
    """Raise unless `shards` are 1 to MAX_SHARDS contiguous int32 CUDA
    tensors of the rows `shard_plane` gives each; returns their stride."""
    if not 1 <= len(shards) <= MAX_SHARDS:
        raise ValueError(f"{len(shards)} shards: the shard table holds 1 to {MAX_SHARDS}")
    bps = shard_rows(nblocks, len(shards))
    for k, shard in enumerate(shards):
        want = (min(bps, max(2 * nblocks - k * bps, 0)), SINGLE_COLS)
        if (shard.device.type != "cuda" or shard.dtype != torch.int32
                or not shard.is_contiguous() or tuple(shard.shape) != want):
            raise ValueError(f"shard {k}: want a contiguous int32 CUDA tensor of shape {want}")
    return bps


_PEER_ACCESS = set()  # (card, peer) index pairs whose peer access is enabled


def _enable_peers(dev: torch.device, shards) -> None:
    """Let `dev` read every shard on another card, once a pair: raises,
    before anything is enabled or launched, naming a pair without peer
    access (a read through such a pointer would be a fault that ends the
    process)."""
    pairs = sorted({(dev.index, s.device.index) for s in shards if s.device != dev} - _PEER_ACCESS)
    for card, peer in pairs:
        if not torch.cuda.can_device_access_peer(card, peer):
            raise ValueError(f"shards on cuda:{peer}: {dev} cannot read them (no peer access)")
    for card, peer in pairs:
        with torch.cuda.device(card):
            kernels.check(kernels.lib().siga_enable_peer_access(peer),
                          f"peer access {dev} -> cuda:{peer}")
        _PEER_ACCESS.add((card, peer))


def scan_single_sharded(
    shards, pred, length: int, nblocks: int, la_words, lens,
    lim_t: int, min_overlap: int, fwd_groups, rev_groups,
    slab_bytes: int | None = None,
):
    """The single-step scan over the stacked single-step plane split into
    row shards (`shard_plane`, shard k on a device of its own, or D
    allocations on one card); one shard is the whole plane (`scan_single`).
    On CUDA every lane runs on la_words' card, in one C entry: one shard
    launches K3 (counted as `scan_single`), more launch K3 reading each row
    from the shard that owns it through a table of the shards' base pointers
    (counted as `scan_single_sharded`).  A shard on another card is a peer
    read, so every such pair must have peer access (enabled at its first
    use; a pair without it raises before any launch).  The slabs split as
    `scan_pair`'s do, sized by la_words' card's free memory.  On CPU tensors
    `scan_single_plain` (one shard) or `scan_single_sharded_plain`; same
    arguments and outputs as `scan_single`, with `shards` in place of the
    plane."""
    return scan_single_sharded_call(
        shards, pred, length, nblocks, la_words, lens,
        lim_t, min_overlap, fwd_groups, rev_groups, slab_bytes,
    ).outputs()


def scan_single_sharded_call(
    shards, pred, length: int, nblocks: int, la_words, lens,
    lim_t: int, min_overlap: int, fwd_groups, rev_groups,
    slab_bytes: int | None = None,
):
    """`scan_single_sharded`'s scan, not yet finished: a `CardScan` of K3 on
    CUDA tensors (the shards checked and their peer access enabled, nothing
    launched yet), a `PlainScan` of the plain version's outputs on CPU
    tensors."""
    dev = la_words.device
    if dev.type == "cpu":
        if len(shards) == 1:
            return PlainScan(scan_single_plain(
                shards[0], pred, length, nblocks, la_words, lens,
                lim_t, min_overlap, fwd_groups, rev_groups,
            ))
        return PlainScan(scan_single_sharded_plain(
            shards, pred, length, nblocks, la_words, lens,
            lim_t, min_overlap, fwd_groups, rev_groups,
        ))
    if dev.type != "cuda":
        raise ValueError(f"scan_single: unsupported device {dev}")
    bps = _check_shards(shards, nblocks)
    _check_lane_inputs(dev, pred, la_words, lens)
    _enable_peers(dev, shards)
    table = (ctypes.c_void_p * len(shards))(*(s.data_ptr() for s in shards))
    p1, _t0 = _scan_params(lim_t, min_overlap)
    n, wpr = la_words.shape
    groups = tuple(fwd_groups) + tuple(rev_groups)
    entry = functools.partial(
        kernels.lib().siga_scan_single,
        table, len(shards), bps, pred.data_ptr(), la_words.data_ptr(), lens.data_ptr(),
        length, nblocks, n, wpr, len(fwd_groups), _groups_code(groups), lim_t, p1,
        n * len(groups),
    )
    name = "scan_single" if len(shards) == 1 else "scan_single_sharded"
    return CardScan(name, entry, n * len(groups), emit_cap(lim_t, min_overlap), dev, slab_bytes)


def occ_stage_a(plane: torch.Tensor, i: torch.Tensor, tab: torch.Tensor):
    """Inclusive occ counts int64 [5, Q] of positions i [Q] (>= -1) in a
    single-step plane of any row count (int32 [rows, 16]), each in the table
    whose rows start at tab [Q].  Port of `occ_all_fused_T`."""
    row, block0, tail = _single_rows(plane.shape[0], i, tab)
    return _occ_from_single_rows(plane[row].T.to(torch.int64), block0, tail)


def _stage_a_inputs(max_t: int, plane, pred, chars, lens, lane_tab, dev):
    """Raise unless the inputs of `scan_stage_a` are what it takes: a
    single-step plane of 16 columns (block 128; no other sample is
    ported), int32 tensors on `dev` of the shapes that chars [L, max_t + 1]
    gives, and max_t >= 0."""
    if plane.dim() != 2 or plane.shape[1] != SINGLE_COLS:
        raise ValueError(f"plane: shape {tuple(plane.shape)}, want [rows, {SINGLE_COLS}] "
                         f"(block {SAMPLE}; no other block is ported)")
    if max_t < 0 or chars.dim() != 2 or chars.shape[1] != max_t + 1:
        raise ValueError(f"chars: shape {tuple(chars.shape)}, want [L, max_t + 1 = {max_t + 1}]")
    L = chars.shape[0]
    inputs = [("plane", plane, None), ("pred", pred, (5,)), ("chars", chars, None),
              ("lens", lens, (L,))]
    if lane_tab is not None:
        inputs.append(("lane_tab", lane_tab, (L,)))
    for name, x, shape in inputs:
        if x.device != dev or x.dtype != torch.int32 or not x.is_contiguous():
            raise ValueError(f"{name}: want a contiguous int32 tensor on {dev}")
        if shape is not None and tuple(x.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(x.shape)} != {shape}")


def scan_stage_a_plain(max_t: int, min_overlap: int, plane, pred, length: int, chars, lens,
                       lane_tab=None):
    """The stage-A scan with '$'-probes of the JAX package's compile check and
    dry run, in plain PyTorch: the reference for the CUDA kernel K9 and the
    path `scan_stage_a` takes on the CPU.  Mirrors
    `siga_tpu/ops/fm_device.py::_scan_stage_a` step for step.

    chars int32 [L, max_t + 1]: chars[:, t] the rank step t prepends
    (seq[l - 2 - t]; anything past l - 2), chars[:, max_t] the read's last
    symbol, which opens the lane's interval; lens int32 [L]; plane a
    single-step plane int32 [rows, 16] (one index, or the stacked forward and
    reverse planes with lane_tab int32 [L] each lane's row offset); pred the
    C array (int32 [5]).  Step t (t <= len - 2 live, the others keep the
    state) emits the state before it and its '$'-probe's validity (size > 0,
    rlo + size - 1 >= 0, t + 1 >= min_overlap).  Returns emitted int32
    [max_t, L, 3] ([lo, rlo, hi - lo]), valid bool [max_t, L], final int32
    [L, 8] ([lo, hi, rlo, rhi] of the full-length interval and of its
    '$'-probe) and lext int32 [L, 5] (u - l of the counts there)."""
    dev = chars.device
    _stage_a_inputs(max_t, plane, pred, chars, lens, lane_tab, dev)
    L = chars.shape[0]
    chars64, lens64 = chars.to(torch.int64), lens.to(torch.int64)
    tab = torch.zeros(L, dtype=torch.int64, device=dev) if lane_tab is None else (
        lane_tab.to(torch.int64))
    tab2 = torch.cat([tab, tab])
    pred64 = pred.to(torch.int64)

    c0 = chars64[:, max_t]
    lo = pred64[c0]
    full = occ_stage_a(plane, torch.full((L,), length - 1, device=dev), tab)
    hi = lo + _sel_rank(full, c0) - 1
    rlo, rhi = lo, hi
    emitted, valids = [], []
    for t in range(max_t):
        both = occ_stage_a(plane, torch.cat([lo - 1, hi]), tab2)
        l_c, u_c = both[:, :L], both[:, L:]
        active = t <= lens64 - 2
        # the '$'-probe (rank 0): prlo = rlo, prhi = rlo + size - 1
        prhi = rlo + u_c[0] - l_c[0] - 1
        valids.append((prhi >= rlo) & (prhi >= 0) & active & (t + 1 >= min_overlap))
        emitted.append(torch.stack([lo, rlo, hi - lo], dim=-1))
        # a symbol past l - 2 is anything: inactive lanes extend by '$', unused
        c = torch.where(active, chars64[:, t], 0)
        new = _update_left(rlo, c, l_c, u_c, pred64)
        lo, hi, rlo, rhi = (torch.where(active, n, o) for n, o in zip(new, (lo, hi, rlo, rhi)))
    both = occ_stage_a(plane, torch.cat([lo - 1, hi]), tab2)
    l_c, u_c = both[:, :L], both[:, L:]
    probe = _update_left(rlo, torch.zeros_like(c0), l_c, u_c, pred64)
    i32 = torch.int32
    if emitted:
        emitted, valid = torch.stack(emitted).to(i32), torch.stack(valids)
    else:
        emitted = torch.zeros((0, L, 3), dtype=i32, device=dev)
        valid = torch.zeros((0, L), dtype=torch.bool, device=dev)
    final = torch.stack([lo, hi, rlo, rhi, *probe], dim=-1).to(i32)
    return emitted, valid, final, (u_c - l_c).T.to(i32).contiguous()


def scan_stage_a(max_t: int, min_overlap: int, plane, pred, length: int, chars, lens,
                 lane_tab=None):
    """The stage-A scan with '$'-probes (`scan_stage_a_plain`'s arguments and
    outputs): the CUDA kernel K9 (`csrc/stage_a.cu`, one launch, a thread a
    lane) on CUDA tensors, the plain version on CPU tensors; any other
    device raises.  Port of `siga_tpu/ops/fm_device.py::_scan_stage_a`.
    Only a 16-column single-step plane is taken; live symbols are ranks
    0..4, as `dna.encode` gives them."""
    dev = chars.device
    if dev.type == "cpu":
        return scan_stage_a_plain(max_t, min_overlap, plane, pred, length, chars, lens, lane_tab)
    if dev.type != "cuda":
        raise ValueError(f"scan_stage_a: unsupported device {dev}")
    _stage_a_inputs(max_t, plane, pred, chars, lens, lane_tab, dev)
    L = chars.shape[0]
    if L == 0 or plane.shape[0] == 0:
        raise ValueError("scan_stage_a: no lanes or an empty plane")
    emitted = torch.empty((max_t, L, 3), dtype=torch.int32, device=dev)
    valid = torch.empty((max_t, L), dtype=torch.bool, device=dev)
    final = torch.empty((L, 8), dtype=torch.int32, device=dev)
    lext = torch.empty((L, 5), dtype=torch.int32, device=dev)
    kernels.launch(
        "scan_stage_a", dev, kernels.lib().siga_scan_stage_a,
        plane.data_ptr(), plane.shape[0], pred.data_ptr(), length, chars.data_ptr(),
        lens.data_ptr(), None if lane_tab is None else lane_tab.data_ptr(), L, max_t,
        min_overlap, emitted.data_ptr(), valid.data_ptr(), final.data_ptr(), lext.data_ptr(),
    )
    return emitted, valid, final, lext


def require_acgt(text: bytes) -> None:
    """Raise unless every byte is one of A, C, G, T.  The native packer would
    take lowercase acgt as bases, while the index (`dna.encode`) reads those
    bytes as '$', so such reads must not reach it."""
    if text.translate(None, b"ACGT"):
        raise ValueError(NON_ACGT)


def pack_reads_2bit(seqs: Sequence[str], n: int, maxlen: int, out=None):
    """2-bit left-aligned packing of a chunk of reads by the C++ runtime.

    Returns (la_words int32 [n, maxlen//16], lens int32 [n]), written into
    `out` where it is given as two such arrays; symbol j sits in bits
    [2j%32, 2j%32+2) of word j//16.  Rows past the reads get length 1.
    Raises on a symbol outside ACGT."""
    lib = native_lib()
    joined = "".join(seqs).encode()
    require_acgt(joined)
    buf = np.frombuffer(joined, dtype=np.uint8)
    offsets = np.zeros(len(seqs) + 1, dtype=np.int64)
    np.cumsum(
        np.fromiter((len(s) for s in seqs), dtype=np.int64, count=len(seqs)),
        out=offsets[1:],
    )
    if len(seqs) and int(np.diff(offsets).max()) > maxlen:
        raise ValueError(f"reads must be at most {maxlen} long")
    if out is None:
        out = np.empty((n, maxlen // 16), dtype=np.int32), np.empty(n, dtype=np.int32)
    la_w, lens = out
    if la_w.shape != (n, maxlen // 16) or lens.shape != (n,):
        raise ValueError(f"out: want int32 arrays of shapes ({n}, {maxlen // 16}) and ({n},)")
    if not all(a.dtype == np.int32 and a.flags.c_contiguous for a in out):
        raise ValueError("out: want contiguous int32 arrays")
    rc = lib.siga_pack_reads_2bit(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(len(seqs)),
        ctypes.c_int64(n),
        ctypes.c_int64(maxlen),
        la_w.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if rc != 0:
        raise ValueError(NON_ACGT)
    return la_w, lens


def pair_step_default() -> bool:
    """The scan route SIGA_PAIR_STEP selects, as in the JAX package: "0" is
    the single-step scan, anything else or unset the pair scan."""
    return os.environ.get("SIGA_PAIR_STEP", "1") != "0"


class DualScanner:
    """One scan serves both orientation pairs of a chunk: the forward and
    reverse planes are stacked and each lane carries its table's row offset.
    The C arrays of the forward and reversed text are equal, so `pred` is
    shared.  Lane layout: forward groups first, then reverse groups, each
    with stride n.

    `pair_step` picks the route: the pair scan K1 over the pair planes
    (True), or the single-step scan K3 (`scan_single`) over the
    single-step planes (False); None reads SIGA_PAIR_STEP as the JAX package
    does ("0" for the single-step scan, anything else or unset for pairs).

    A list of D `devices` (the port's stand-in for the JAX package's mesh
    in `DualScanner(dfwd, drev, mesh, shard_index=True)`) selects the
    capacity mode for an index larger than one device: the stacked
    single-step plane is packed on the host and its rows split into D
    contiguous ranges, range k copied to devices[k] (`shard_plane`), so no
    device holds the whole plane and `DeviceFM.occ_plane` is never built;
    the route is the single-step scan, over the shards
    (`scan_single_sharded`), with pred and every lane on devices[0].  The
    views are the replicated scan's.  (The lane split over a device list is
    `parallel/dist.py`'s.)

    A chunk goes through in two halves, so that several can be in flight:
    `dispatch` enqueues the upload, the scan, the compaction into the
    scanner's sticky budgets and the copy back, and never waits on the card;
    `collect` waits once for that copy and decodes the views (a second copy
    only where a budget overflowed).  The slab budget a chunk is sized once,
    at construction (`_slab_share`).  `stats` counts the chunks collected,
    the host waits, the copies back and the overflows."""

    def __init__(self, dfwd: DeviceFM, drev: DeviceFM,
                 fwd_groups=(GROUP_ID, GROUP_RC),
                 rev_groups=(GROUP_REV, GROUP_COMP),
                 pair_step: bool | None = None,
                 devices=None):
        if (dfwd.length, dfwd.nblocks, dfwd.device) != (
            drev.length, drev.nblocks, drev.device
        ):
            raise ValueError("forward and reverse indexes differ in size or device")
        self.length = dfwd.length
        self.nblocks = dfwd.nblocks
        self.fwd_groups = tuple(fwd_groups)
        self.rev_groups = tuple(rev_groups)
        self.shards = None
        # sticky budgets of the packed outputs, set at the first dispatch
        self._rows = self._cands = 0
        self.stats = {"chunks": 0, "host_waits": 0, "copies": 0, "overflows": 0}
        if devices is not None:
            devices = device_list(devices)
            if len(devices) > MAX_SHARDS:
                raise ValueError(f"{len(devices)} devices: the shard table holds {MAX_SHARDS}")
            # the sharded capacity mode runs the single-step scan, as in JAX
            self.pair = False
            self.device = devices[0]
            self.shards = shard_plane(
                torch.cat([dfwd.single_step_rows().cpu(), drev.single_step_rows().cpu()]), devices
            )
            self.plane = self.K2 = None
            self.pred = torch.as_tensor(dfwd.pred, dtype=torch.int32, device=self.device)
            self.slab_bytes = _slab_share(self.device)
            return
        self.pair = pair_step_default() if pair_step is None else bool(pair_step)
        self.device = dfwd.device
        if self.pair:
            self.plane = torch.cat([dfwd.plane, drev.plane]).contiguous()
            self.K2 = torch.stack([dfwd.K, drev.K]).contiguous()
        else:
            self.plane = torch.cat([dfwd.occ_plane, drev.occ_plane]).contiguous()
            self.K2 = None
        self.pred = dfwd.pred_dev
        self.slab_bytes = _slab_share(self.device)

    def dispatch(self, seqs: Sequence[str], n: int, maxlen: int, min_overlap: int):
        """Enqueue the scan of all orientation lanes of a chunk of at most n
        reads, and the copy of its outputs back to the host; returns the
        chunk's `ScanHandle` for `collect`.  maxlen must be a multiple of 16
        and at least the longest read.  Nothing here waits on the card: the
        reads are packed into pinned host memory and uploaded without
        blocking, and the outputs are packed on the card into the sticky
        budgets and copied to a pinned buffer of the handle's."""
        pin = self.device.type == "cuda"
        la_h = torch.empty((n, maxlen // 16), dtype=torch.int32, pin_memory=pin)
        lens_h = torch.empty(n, dtype=torch.int32, pin_memory=pin)
        pack_reads_2bit(seqs, n, maxlen, out=(la_h.numpy(), lens_h.numpy()))
        # the scan goes only as deep as the chunk's longest read
        lim_t = min(maxlen - 1, int(lens_h.numpy().max()) - 1)
        la_words = la_h.to(self.device, non_blocking=True)
        lens_d = lens_h.to(self.device, non_blocking=True)
        args = (self.pred, self.length, self.nblocks, la_words, lens_d, lim_t, min_overlap,
                self.fwd_groups, self.rev_groups)
        if self.shards is not None:
            scan = scan_single_sharded_call(self.shards, *args, slab_bytes=self.slab_bytes)
        elif self.pair:
            scan = scan_pair_call(self.plane, self.K2, *args, slab_bytes=self.slab_bytes)
        else:
            scan = scan_single_sharded_call([self.plane], *args, slab_bytes=self.slab_bytes)
        lanes = n * (len(self.fwd_groups) + len(self.rev_groups))
        handle = ScanHandle(scan, n, lanes, lim_t, min_overlap, (la_h, lens_h, la_words, lens_d))
        if not self._rows:
            # the first chunk's guess, grown as chunks show more
            self._rows = _granule(ROWS_A_LANE * lanes, ROW_GRANULE)
            self._cands = _granule(CANDS_A_READ * n, CAND_GRANULE)
        self._ship(handle)
        return handle

    def _ship(self, handle):
        """Pack `handle`'s scan into the current budgets (no more than it can
        hold) and start the copy back to the host."""
        lanes = handle.lanes
        handle.rows = min(self._rows, lanes * emit_cap(handle.lim_t, handle.min_overlap))
        handle.cands = min(self._cands, lanes)
        packed = handle.scan.pack(handle.rows, handle.cands)
        if packed.device.type == "cpu":
            handle.host, handle.done = packed, None
            return
        handle.host = torch.empty(packed.shape, dtype=torch.int32, pin_memory=True)
        handle.host.copy_(packed, non_blocking=True)
        handle.done = torch.cuda.Event()
        handle.done.record(torch.cuda.current_stream(packed.device))
        handle.packed = packed
        self.stats["copies"] += 1

    def collect(self, handle):
        """The views of a dispatched chunk: (f_view, r_view), each (lane, t,
        data4, cand_lanes, cand_rows6, substr_flags) as numpy arrays:
          lane/t/data4: emitted blocks, lane-major and t ascending, with
            data4 = [lo, hi, rlo, rhi] (hi and rhi from the size invariant);
          cand_lanes: lanes whose full-length '$'-probe is a valid pair
            (containment candidates), ascending;
          cand_rows6: [flo, fhi, frlo, frhi, occ_$(flo-1), occ_$(fhi)] per
            candidate;
          substr_flags: uint8 [lanes], lext|rext DNA extension of the
            full-length interval.
        Both routes give the same views; their trel counts from t0 =
        2 * (p1 // 2) (pairs) or from p1 (single steps).

        One host wait on the card, for the copy `dispatch` started, unless
        the header shows more rows or candidates than the budgets held:
        then the budgets grow (for this and every later chunk) and the
        outputs are packed and copied again.  Handles may be collected in
        any order."""
        lanes = handle.lanes
        cap = emit_cap(handle.lim_t, handle.min_overlap)
        while True:
            if handle.done is not None:
                handle.done.synchronize()
                self.stats["host_waits"] += 1
            buf = handle.host.numpy()
            (total, most, n_cand), parts = unpack_scan(buf, lanes, handle.rows, handle.cands)
            if most > cap:
                raise RuntimeError(f"scan: a lane emitted {most} rows, its slab holds {cap}")
            if total <= handle.rows and n_cand <= handle.cands:
                break
            self._rows = max(self._rows, _granule(total, ROW_GRANULE))
            self._cands = max(self._cands, _granule(n_cand, CAND_GRANULE))
            self.stats["overflows"] += 1
            self._ship(handle)
        self.stats["chunks"] += 1
        lane_counts, rows, candmask, candT, subwords = parts
        half = handle.n * len(self.fwd_groups)
        p1, t0 = _scan_params(handle.lim_t, handle.min_overlap)
        t0 = t0 if self.pair else p1
        lane = np.repeat(np.arange(lanes, dtype=np.int64), lane_counts)
        lo, rlo, size, trel = rows.T.astype(np.int64)
        data = np.stack([lo, lo + size, rlo, rlo + size], axis=1)
        t = trel + t0
        cand_lanes = np.flatnonzero(_bits(candmask, lanes)).astype(np.int64)
        flo, frlo, l0, fsize, psize = candT.astype(np.int64)
        cand_rows = np.stack([flo, flo + fsize, frlo, frlo + fsize, l0, l0 + psize], axis=1)
        subbits = _bits(subwords, lanes)
        is_f = lane < half
        cf = cand_lanes < half
        f_view = (lane[is_f], t[is_f], data[is_f],
                  cand_lanes[cf], cand_rows[cf], subbits[:half])
        r_view = (lane[~is_f] - half, t[~is_f], data[~is_f],
                  cand_lanes[~cf] - half, cand_rows[~cf], subbits[half:])
        return f_view, r_view


def _slab_share(dev: torch.device) -> int | None:
    """A scanner's slab budget a chunk: a third of the card's free memory,
    read once, shared over CHUNKS_IN_FLIGHT chunks (None on the CPU)."""
    if dev.type != "cuda":
        return None
    return torch.cuda.mem_get_info(dev)[0] // 3 // CHUNKS_IN_FLIGHT


def _bits(words: np.ndarray, L: int) -> np.ndarray:
    """uint8 [L]: bit j of int32 word w is entry 32 w + j."""
    return np.unpackbits(np.ascontiguousarray(words).view(np.uint8), bitorder="little")[:L]


def _granule(x: int, g: int) -> int:
    """x rounded up to a multiple of g, at least g."""
    return max(g, -(-x // g) * g)


# The first chunk's budgets: rows a lane (8.5 a lane at 25x coverage of
# 150 bp reads and -m 45) and containment candidates a read (each read is
# one at least, in its ID and REV lanes); they grow in granules.
ROWS_A_LANE = 12
CANDS_A_READ = 3
ROW_GRANULE = 8192
CAND_GRANULE = 4096
CHUNKS_IN_FLIGHT = 8  # chunks that share a scanner's slab budget (ops/search.py LOOKAHEAD)


class ScanHandle:
    """A dispatched chunk: its scan (`CardScan` or `PlainScan`), the shape
    of its scan, and every tensor the stream may still use: the pinned
    reads and their copies on the card, the packed outputs and their pinned
    copy (`host`), with the event that marks the copy done (`done`, None
    on the CPU) and the budgets it was packed into (`rows`, `cands`)."""

    def __init__(self, scan, n: int, lanes: int, lim_t: int, min_overlap: int, inputs):
        self.scan, self.n, self.lanes = scan, n, lanes
        self.lim_t, self.min_overlap = lim_t, min_overlap
        self.inputs = inputs
        self.packed = self.host = self.done = None
        self.rows = self.cands = 0
