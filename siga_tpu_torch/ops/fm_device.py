"""Device FM-index pair plane and the stage-A pair scan, on PyTorch.

Port of the pair-step path of `siga_tpu/ops/fm_device.py`.  An FM-index
lives on the device as its pair plane: one 57-column int32 row per
128-symbol BWT block (cur and prev 2-bit symbol words, their '$' masks in
even-bit format, and 25 exclusive pair checkpoints), plus the 5x5 closure K
with K[c2][c1] = C(c2) + occ_c2(C(c1) - 1), so that two backward-search
steps are one row read:  lo'' = K[c2][c1] + occ2((c2, c1), lo - 1).

The scan (`scan_pair`) is the hand-written CUDA kernel K1
(`csrc/scan_pair.cu`) on a CUDA tensor and its plain PyTorch version
`scan_pair_plain` on a CPU tensor.  The plain helpers below work in int64
with explicit 32-bit masks: PyTorch has no popcount and no shifts on uint32.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np
import torch

from siga_tpu.index.fm import SAMPLE, FMIndex

from .. import kernels
from ..device import native_lib

PAIR_COLS = 57  # 8 cur + 8 prev + 8 cur$ + 8 prev$ + 25 ckpt (sample=128)
_LO_BITS = 0x55555555
_U32 = 0xFFFFFFFF

# Lane-group transform ids: how a lane's scan sequence derives from the read.
GROUP_ID = 0    # seq itself (suffix search in the forward index)
GROUP_RC = 1    # reverse_complement(seq) (forward index)
GROUP_REV = 2   # reverse(seq) (reverse index)
GROUP_COMP = 3  # complement(seq) (reverse index)


def _i32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding 32 bits -> int32 with the same bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 -> int64 holding the same bits as an unsigned value."""
    return x.to(torch.int64) & _U32


class DeviceFM:
    """Pair plane of one FM-index on `device`.

    plane: int32 [nblocks, 57]; K: int32 [5, 5]; pred: the C array (host
    int64 [5]); pred_dev: the same as int32 on `device`, for the kernels."""

    def __init__(self, host: FMIndex, device):
        self.device = torch.device(device)
        self.length = host.length
        self.nblocks = host.length // SAMPLE + 1
        self.pred = np.asarray(host.pred, dtype=np.int64)
        self.pred_dev = torch.as_tensor(self.pred, dtype=torch.int32, device=self.device)
        codes = torch.from_numpy(np.ascontiguousarray(host.codes)).to(self.device)
        self.plane, self.K = _build_pair_plane_dev(codes, self.pred, self.nblocks)

    @classmethod
    def from_jax_state(cls, plane, K, pred, length: int, nblocks: int, device):
        """Adopt the JAX package's pair plane and K (numpy arrays, as from
        `siga_tpu.ops.fm_device.DeviceFM.pair_plane_device()`)."""
        plane = np.asarray(plane)
        if plane.shape != (nblocks, PAIR_COLS):
            raise ValueError(f"plane shape {plane.shape} != ({nblocks}, {PAIR_COLS})")
        self = cls.__new__(cls)
        self.device = torch.device(device)
        self.length = int(length)
        self.nblocks = int(nblocks)
        self.pred = np.asarray(pred, dtype=np.int64)
        self.pred_dev = torch.as_tensor(self.pred, dtype=torch.int32, device=self.device)
        self.plane = torch.from_numpy(plane.astype(np.int32)).to(self.device)
        self.K = torch.from_numpy(np.asarray(K).astype(np.int32)).to(self.device)
        return self


def pair_plane_host(host: FMIndex):
    """The pair plane and K packed on the host by the C++ runtime
    (`siga_pack_pair_plane`): an implementation independent of
    `_build_pair_plane_dev`, to check it against.  Returns (plane int32
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


def _build_pair_plane_dev(codes: torch.Tensor, pred: np.ndarray, nblocks: int):
    """Pair plane and K from the BWT codes (uint8 [n], on the device).

    Port of the XLA program `siga_tpu/ops/fm_device.py::_build_pair_plane_dev`
    in plain tensor ops; it runs once per index.  prev at BWT row r is
    codes[LF(r)] (0 for '$' rows and the padding past n, which also counts
    as '$' in the masks)."""
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
    n = la_words.shape[0]
    groups = tuple(fwd_groups) + tuple(rev_groups)
    lens64 = lens.to(torch.int64)
    charsT = _lane_chars(la_words, lens64, groups)
    max_t = charsT.shape[0] - 1
    L = charsT.shape[1]
    lens_all = lens64.repeat(len(groups))
    is_fwd = torch.arange(L, device=dev) < n * len(fwd_groups)
    tab = torch.where(is_fwd, 0, nblocks)
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

    if emitted:
        valid = torch.cat(valids, dim=1)  # [L, T2], t ascending per lane
        emit = torch.cat(emitted, dim=1)[valid]  # [blocks, 4], lane-major
        lane_counts = valid.sum(dim=1)
    else:
        emit = torch.zeros((0, 4), dtype=torch.int64, device=dev)
        lane_counts = zeros

    # finals: containment/substring classification of the full interval
    fs, _ = occ(torch.cat([lo - 1, hi]), tab2)
    l_c, u_c = fs[:, :L], fs[:, L:]
    lext_dna = (u_c[1:] - l_c[1:]).sum(dim=0) > 0
    other = nblocks - tab
    fr, _ = occ(torch.cat([rlo - 1, rhi]), torch.cat([other, other]))
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


def _check_scan_inputs(plane2, K2, pred, nblocks, la_words, lens):
    dev = plane2.device
    for name, x, shape in (
        ("plane2", plane2, (2 * nblocks, PAIR_COLS)),
        ("K2", K2, (2, 5, 5)),
        ("pred", pred, (5,)),
        ("la_words", la_words, None),
        ("lens", lens, (la_words.shape[0],)),
    ):
        if x.device != dev or x.dtype != torch.int32 or not x.is_contiguous():
            raise ValueError(f"{name}: want a contiguous int32 tensor on {dev}")
        if shape is not None and tuple(x.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(x.shape)} != {shape}")


def scan_pair(
    plane2, K2, pred, length: int, nblocks: int, la_words, lens,
    lim_t: int, min_overlap: int, fwd_groups, rev_groups,
):
    """The stage-A pair scan: the CUDA kernel K1 on CUDA tensors,
    `scan_pair_plain` on CPU tensors; same arguments and outputs."""
    dev = plane2.device
    if dev.type == "cpu":
        return scan_pair_plain(
            plane2, K2, pred, length, nblocks, la_words, lens,
            lim_t, min_overlap, fwd_groups, rev_groups,
        )
    if dev.type != "cuda":
        raise ValueError(f"scan_pair: unsupported device {dev}")
    _check_scan_inputs(plane2, K2, pred, nblocks, la_words, lens)
    n, wpr = la_words.shape
    groups = tuple(fwd_groups) + tuple(rev_groups)
    L = n * len(groups)
    p1, t0 = _scan_params(lim_t, min_overlap)
    lane_counts = torch.empty(L, dtype=torch.int32, device=dev)
    fall = torch.empty((5, L), dtype=torch.int32, device=dev)
    nw = -(-L // 32)
    candmask = torch.empty(nw, dtype=torch.int32, device=dev)
    subwords = torch.empty(nw, dtype=torch.int32, device=dev)
    groups_code = sum(g << (2 * k) for k, g in enumerate(groups))
    args = (
        plane2.data_ptr(), K2.data_ptr(), pred.data_ptr(),
        la_words.data_ptr(), lens.data_ptr(),
        length, nblocks, n, wpr, len(fwd_groups), groups_code,
        lim_t, p1, t0, L,
    )
    if L == 0:
        raise ValueError("scan_pair: no lanes")
    lib = kernels.lib()
    stream = kernels.stream_ptr(dev)
    kernels.check(
        lib.siga_scan_pair_count(
            *args, lane_counts.data_ptr(), fall.data_ptr(),
            candmask.data_ptr(), subwords.data_ptr(), stream,
        ),
        "scan_pair count pass",
    )
    ends = torch.cumsum(lane_counts, dim=0)
    offsets = ends - lane_counts
    total = int(ends[-1])
    emit = torch.empty((total, 4), dtype=torch.int32, device=dev)
    if total:
        kernels.check(
            lib.siga_scan_pair_emit(*args, offsets.data_ptr(), emit.data_ptr(), stream),
            "scan_pair emit pass",
        )
    kernels.launches["scan_pair"] += 1
    candT = fall[:, _unpack_bits32(candmask, L)]
    counts = torch.tensor([total, candT.shape[1]], dtype=torch.int32, device=dev)
    return counts, lane_counts, emit[:, :3].T, emit[:, 3], candmask, candT, subwords


def pack_reads_2bit(seqs: Sequence[str], n: int, maxlen: int):
    """2-bit left-aligned packing of a chunk of reads by the C++ runtime.

    Returns (la_words int32 [n, maxlen//16], lens int32 [n]); symbol j sits
    in bits [2j%32, 2j%32+2) of word j//16.  Rows past the reads get length
    1.  Raises on a symbol outside ACGT."""
    lib = native_lib()
    joined = "".join(seqs).encode()
    buf = np.frombuffer(joined, dtype=np.uint8)
    offsets = np.zeros(len(seqs) + 1, dtype=np.int64)
    np.cumsum(
        np.fromiter((len(s) for s in seqs), dtype=np.int64, count=len(seqs)),
        out=offsets[1:],
    )
    if offsets[-1] != buf.size or (len(seqs) and int(np.diff(offsets).max()) > maxlen):
        raise ValueError("reads must be ASCII and at most maxlen long")
    la_w = np.empty((n, maxlen // 16), dtype=np.int32)
    lens = np.empty(n, dtype=np.int32)
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
        raise ValueError(
            "read contains non-ACGT symbols; run `siga preprocess` first"
        )
    return la_w, lens


class DualScanner:
    """One scan serves both orientation pairs of a chunk: the forward and
    reverse planes are stacked and each lane carries its table's row offset.
    The C arrays of the forward and reversed text are equal, so `pred` is
    shared.  Lane layout: forward groups first, then reverse groups, each
    with stride n."""

    def __init__(self, dfwd: DeviceFM, drev: DeviceFM,
                 fwd_groups=(GROUP_ID, GROUP_RC),
                 rev_groups=(GROUP_REV, GROUP_COMP)):
        if (dfwd.length, dfwd.nblocks, dfwd.device) != (
            drev.length, drev.nblocks, drev.device
        ):
            raise ValueError("forward and reverse indexes differ in size or device")
        self.device = dfwd.device
        self.length = dfwd.length
        self.nblocks = dfwd.nblocks
        self.fwd_groups = tuple(fwd_groups)
        self.rev_groups = tuple(rev_groups)
        self.plane = torch.cat([dfwd.plane, drev.plane]).contiguous()
        self.K2 = torch.stack([dfwd.K, drev.K]).contiguous()
        self.pred = dfwd.pred_dev

    def dispatch(self, seqs: Sequence[str], n: int, maxlen: int, min_overlap: int):
        """Scan all orientation lanes of a chunk of at most n reads.
        maxlen must be a multiple of 16 and at least the longest read."""
        la_w, lens = pack_reads_2bit(seqs, n, maxlen)
        # the scan goes only as deep as the chunk's longest read
        lim_t = min(maxlen - 1, int(lens.max()) - 1)
        out = scan_pair(
            self.plane, self.K2, self.pred, self.length, self.nblocks,
            torch.from_numpy(la_w).to(self.device),
            torch.from_numpy(lens).to(self.device),
            lim_t, min_overlap, self.fwd_groups, self.rev_groups,
        )
        return out, n, lim_t, min_overlap

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
            full-length interval."""
        out, n, lim_t, min_overlap = handle
        _counts, lane_counts, data3T, trel, candmask, candT, subwords = out
        dev = lane_counts.device
        num_lanes = n * (len(self.fwd_groups) + len(self.rev_groups))
        half = n * len(self.fwd_groups)
        _p1, t0 = _scan_params(lim_t, min_overlap)
        lane = torch.repeat_interleave(
            torch.arange(num_lanes, device=dev), lane_counts.to(torch.int64)
        )
        lo, rlo, size = data3T.to(torch.int64)
        data = torch.stack([lo, lo + size, rlo, rlo + size], dim=1)
        cand_lanes = torch.nonzero(_unpack_bits32(candmask, num_lanes)).flatten()
        flo, frlo, l0, fsize, psize = candT.to(torch.int64)
        cand_rows = torch.stack(
            [flo, flo + fsize, frlo, frlo + fsize, l0, l0 + psize], dim=1
        )
        subbits = _unpack_bits32(subwords, num_lanes).to(torch.uint8)
        lane, t, data, cand_lanes, cand_rows, subbits = (
            x.cpu().numpy()
            for x in (lane, trel.to(torch.int64) + t0, data, cand_lanes, cand_rows, subbits)
        )
        is_f = lane < half
        cf = cand_lanes < half
        f_view = (lane[is_f], t[is_f], data[is_f],
                  cand_lanes[cf], cand_rows[cf], subbits[:half])
        r_view = (lane[~is_f] - half, t[~is_f], data[~is_f],
                  cand_lanes[~cf] - half, cand_rows[~cf], subbits[half:])
        return f_view, r_view
