"""Gather probes G1-G4: the Pallas gather probes of `benchmark/probes/` as
hand-written CUDA (`csrc/gather_probe.cu`), each with its plain PyTorch
version.

A wrapper launches its kernel on CUDA tensors and runs the plain version on
CPU tensors.  The kernels measure on the card what the TPU probes measured on
a TPU core: how fast rows and lanes are gathered, and how long one step of a
dependent chain of gathers takes, which is the floor for the stage-A scan
K1.  Integer arithmetic wraps at 32 bits, as JAX's int32 does, and `%` is
the floor modulo (non-negative for a positive modulus).

    python -m siga_tpu_torch.probes.gather --plane PREFIX

times the four kernels on the stacked pair plane of the index PREFIX.bwt /
PREFIX.rbwt, the plane the overlap scan reads (it needs a card).
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

import numpy as np
import torch

from .. import kernels

MODES = ("sum", "elem")


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 with the same low 32 bits (two's complement)."""
    return ((x + 2**31) & 0xFFFFFFFF) - 2**31


def _check(name: str, x: torch.Tensor, dev, dim: int, contiguous: bool = True) -> None:
    if x.device != dev or x.dtype != torch.int32 or x.dim() != dim:
        raise ValueError(f"{name}: want a {dim}-d int32 tensor on {dev}")
    if contiguous and not x.is_contiguous():
        raise ValueError(f"{name}: want a contiguous tensor")
    if x.numel() == 0:
        raise ValueError(f"{name}: empty")


def _check_range(name: str, idx: torch.Tensor, hi: int) -> None:
    """0 <= idx < hi on a CPU tensor.  On a card the kernel checks each index
    it reads instead (a device-side assert, raised at the next
    synchronisation), so a wrapper never waits on the card."""
    if idx.numel() == 0:
        return
    lo_v, hi_v = int(idx.min()), int(idx.max())
    if lo_v < 0 or hi_v >= hi:
        raise ValueError(f"{name}: values in [{lo_v}, {hi_v}], want [0, {hi})")




# ---- G1: row gather ------------------------------------------------------

def gather_rows_plain(plane: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """plane int32 [R, C], idx int32 [Q] -> plane[idx] int32 [Q, C]."""
    return plane[idx.to(torch.int64)]


def gather_rows(plane: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """G1: `gather_rows_plain` as the CUDA kernel on CUDA tensors; an index
    outside [0, R) raises."""
    dev = plane.device
    if dev.type == "cpu":
        _check_range("gather_rows idx", idx, plane.shape[0])
        return gather_rows_plain(plane, idx)
    _check("plane", plane, dev, 2)
    _check("idx", idx, dev, 1)
    (R, C), Q = plane.shape, idx.shape[0]
    out = torch.empty((Q, C), dtype=torch.int32, device=dev)
    kernels.launch("gather_rows", dev, kernels.lib().siga_gather_rows,
                   plane.data_ptr(), idx.data_ptr(), R, Q, C, out.data_ptr())
    return out


# ---- G2: take_along_axis -------------------------------------------------

def _take_shape(table: torch.Tensor, index: torch.Tensor, axis: int):
    """Output shape of take_along(table [A, B], index, axis); the index's
    other dimension is the table's or 1 (broadcast)."""
    if axis not in (0, 1):
        raise ValueError(f"take_along: axis {axis}, want 0 or 1")
    other = 1 - axis
    if index.shape[other] not in (1, table.shape[other]):
        raise ValueError(
            f"take_along: index shape {tuple(index.shape)} does not broadcast "
            f"against table {tuple(table.shape)} off axis {axis}"
        )
    shape = list(index.shape)
    shape[other] = table.shape[other]
    return tuple(shape)


def take_along_plain(table: torch.Tensor, index: torch.Tensor, axis: int) -> torch.Tensor:
    """take_along_axis(table int32 [A, B], index int32 2-d, axis): out[i, j] =
    table[index[i, j], j] (axis 0) or table[i, index[i, j]] (axis 1); the
    index's other dimension may be 1 and then broadcasts."""
    shape = _take_shape(table, index, axis)
    return torch.gather(table, axis, index.to(torch.int64).expand(shape))


# G2's forms (csrc/gather_probe.cu numbers them alike)
AXIS0, SHARED, DIRECT = range(3)
FORMS = ("axis 0", "shared", "direct")
TAKE_THREADS = 256
SHARED_THREADS = 1024  # a block of the shared form
SMEM_MAX = 227 * 1024  # shared memory a block can use on Hopper


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def take_along_plan(A: int, B: int, Q: int, axis: int, sms: int):
    """G2's form and block shape for take_along on a table [A, B] with Q
    outputs a row (axis 1) or Q output rows (axis 0), on a card of `sms`
    SMs: (form, tile), tile the threads a block (DIRECT, AXIS0) or the
    output columns a block (SHARED).  On axis 1 the kernel takes a block for
    each (table row, tile of columns).

    SHARED copies a table row to shared memory (B / 8 sectors read in order)
    and serves a tile of at least B / 4 outputs from it, where one random
    read an output would fetch a sector each.  It is chosen when the row
    fits, the row has at least B / 4 outputs, and the tiles give at least a
    block for every two SMs: fewer 1024-thread blocks leave the card idle.
    DIRECT reads in place, one output a thread.  The two forced in turn,
    shared against direct, in two runs of chip_smoke.py on an H100 80GB HBM3
    at 700 W (PERF.md): k2 (128 shared blocks) 0.0049-0.0050 against
    0.0063-0.0065 ms, k_lane (96) 0.0036-0.0038 against 0.0038-0.0039, k_c
    (32) 0.0036-0.0037 against 0.0030, k_a (8) 0.0029-0.0030 against
    0.0023-0.0024."""
    if axis == 0:
        return AXIS0, TAKE_THREADS
    tile = _cdiv(max(B // 4, 1), SHARED_THREADS) * SHARED_THREADS
    if B * 4 <= SMEM_MAX and 4 * Q >= B and 2 * A * _cdiv(Q, tile) >= sms:
        return SHARED, tile
    return DIRECT, min(TAKE_THREADS, _cdiv(Q, 32) * 32)


def take_along_geometry(table: torch.Tensor, index: torch.Tensor, axis: int):
    """(A, B, Q, si0, si1) of take_along(table [A, B], index, axis): Q outputs
    a row (axis 1) or output rows (axis 0), and the index's strides, 0 along
    a broadcast dimension."""
    A, B = table.shape
    Q = _take_shape(table, index, axis)[axis]
    si0 = index.shape[1] if index.shape[0] > 1 else 0
    si1 = 1 if index.shape[1] > 1 else 0
    return A, B, Q, si0, si1


def take_along(table: torch.Tensor, index: torch.Tensor, axis: int) -> torch.Tensor:
    """G2: `take_along_plain` as the CUDA kernel on CUDA tensors; an index
    outside the table's extent along `axis` raises."""
    dev = table.device
    shape = _take_shape(table, index, axis)
    _check("table", table, dev, 2)
    _check("index", index, dev, 2)
    if dev.type == "cpu":
        _check_range("take_along index", index, table.shape[axis])
        return take_along_plain(table, index, axis)
    A, B, Q, si0, si1 = take_along_geometry(table, index, axis)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    form, tile = take_along_plan(A, B, Q, axis, sms)
    out = torch.empty(shape, dtype=torch.int32, device=dev)
    kernels.launch("take_along", dev, kernels.lib().siga_take_along,
                   table.data_ptr(), index.data_ptr(), A, B, Q, si0, si1, axis, form, tile,
                   out.data_ptr())
    return out


# ---- G3: dependent gather chains ----------------------------------------

def gather_chain_plain(table, init, c: Optional[torch.Tensor], steps: int, mode: str):
    """The dependent recurrences of the TPU probes k_scan and k_d on table
    int32 [W, N] (any strides); the modulus is N.

    mode "sum": init int32 [L] in [0, N); for t < steps:
        state = (state + sum_w table[w, (state + t) % N] + c[t % len(c)]) % N
    mode "elem": init int32 [W, M] in [0, N); for s < steps:
        state[w, m] = (state + table[w, state] + s) % N
    Returns the final states (int32, init's shape)."""
    if mode not in MODES:
        raise ValueError(f"gather_chain: mode {mode!r}, want one of {MODES}")
    N = table.shape[1]
    state = init.to(torch.int64)
    t64 = table.to(torch.int64)
    if mode == "sum":
        c64 = c.to(torch.int64)
        for t in range(steps):
            g = t64[:, (state + t) % N].sum(dim=0)
            state = _wrap32(state + g + c64[t % c64.numel()]) % N
    else:
        for s in range(steps):
            state = _wrap32(state + t64.gather(1, state) + s) % N
    return state.to(torch.int32)


CHAIN_GROUPS = (1, 2, 4, 8)  # threads a lane of G3's mode sum (csrc/gather_probe.cu)
CHAIN_LATENCY_THREADS = 512  # threads an SM below which G3's lanes are latency-bound
RESIDENT_THREADS = 2048  # threads an SM of Hopper


def chain_plan(W: int, contiguous: bool, L: int, sms: int) -> int:
    """G3 mode sum's threads a lane, G in CHAIN_GROUPS, for a step that sums
    W words of a row (`contiguous`: sw == 1, read as 16-byte vectors) or of
    a strided column, over L lanes on a card of `sms` SMs.

    A warp's step waits for the slowest of its lanes' loads, so where the
    lanes are few (8 L at most CHAIN_LATENCY_THREADS an SM) a lane takes 8
    threads and a warp holds 4 lanes.  Where they are many, each thread
    repeats the step's state update and index arithmetic, so one thread a
    lane wins, except on rows of 8 or more 16-byte vectors (K1's 57 words
    span 15), whose loads a group splits: 8 threads while the card holds
    them all (RESIDENT_THREADS an SM), else 4.  chip_smoke.py times every
    G on an H100 80GB HBM3 at 700 W (ms, G = 1 / 2 / 4 / 8): k_scan's
    [24, 8192] x 112, 8,192 lanes, 0.1843 / 0.1374 / 0.0713 / 0.0610; the
    pair plane's rows x 150, 60,608 lanes, 0.6604 / 0.5499 / 0.4239 /
    0.4323; its sweep over lane counts and widths, and where the rule
    misses the fastest G, is in PERF.md."""
    if 8 * L <= CHAIN_LATENCY_THREADS * sms:
        return 8
    if contiguous and (W + 6) // 4 >= 8:  # the most 16-byte vectors a row spans
        return 8 if 8 * L <= RESIDENT_THREADS * sms else 4
    return 1


def chain_sum(table, init, c, steps: int, group: int):
    """Launch G3's mode sum with `group` threads a lane (CUDA tensors, checked
    by `gather_chain`); `gather_chain` takes the group from `chain_plan`."""
    W, N = table.shape
    sw, sx = table.stride()
    out = torch.empty_like(init)
    kernels.launch(
        "gather_chain", table.device, kernels.lib().siga_gather_chain_sum,
        table.data_ptr(), sw, sx, W, N, init.data_ptr(), c.data_ptr(), c.numel(),
        steps, init.numel(), group, out.data_ptr(),
    )
    return out


ELEM_TILE = 512  # lanes, one a thread, of a block of G3 mode elem's shared form


def chain_elem_plan(W: int, N: int, sx: int, M: int, sms: int) -> int:
    """G3 mode elem's form, SHARED or DIRECT, for a table [W, N] whose words
    lie `sx` apart, with M lanes a row, on a card of `sms` SMs.

    SHARED stages each row in shared memory (16-byte copies where it is
    contiguous and aligned) and walks the chains there, a block for each
    (row, ELEM_TILE lanes); DIRECT, one thread a lane, reads every step's
    word in place.  G2's test picks SHARED: a contiguous row (sx == 1; a
    strided row's staging reads a sector a word) that fits in shared memory,
    at least N / 4 lanes to pay for its staging, and at least a block for
    every two SMs.  A step of the shared form is bound by the bank conflicts
    of a warp's 32 random loads, so the lanes are best spread one block an
    SM: each tile forced in turn at k_d's [8, 8192] x 100 in a run of
    chip_smoke.py on an H100 80GB HBM3 at 700 W (PERF.md), tiles of 256 /
    512 / 1,024 lanes took 0.0068 / 0.0063 / 0.0092 ms (0.0039 / 0.0033 /
    0.0035 with no steps: 256 lanes stage each row on two blocks an SM,
    1,024 put twice the loads on 64 SMs), and at N = 8,184 (no power of
    two) 0.0085 / 0.0073 / 0.0095; the direct form 0.0171 and 0.0170."""
    if sx == 1 and 4 * N <= SMEM_MAX and 4 * M >= N and 2 * W * _cdiv(M, ELEM_TILE) >= sms:
        return SHARED
    return DIRECT


def chain_elem_tile(M: int) -> int:
    """Lanes (and threads) a block of the shared form: ELEM_TILE, or M rounded
    up to a warp where a row has fewer."""
    return min(ELEM_TILE, _cdiv(M, 32) * 32)


def chain_elem(table, init, steps: int, form: int, tile: Optional[int] = None):
    """Launch G3's mode elem in `form`, SHARED or DIRECT (CUDA tensors,
    checked by `gather_chain`), SHARED with `tile` lanes a block (default
    `chain_elem_tile`); `gather_chain` takes the form from
    `chain_elem_plan`.  A launch the card refuses (SHARED past its shared
    memory) raises."""
    W, N = table.shape
    sw, sx = table.stride()
    M = init.shape[1]
    out = torch.empty_like(init)
    kernels.launch(
        "gather_chain", table.device, kernels.lib().siga_gather_chain_elem,
        table.data_ptr(), sw, sx, W, N, init.data_ptr(), M, steps, form,
        chain_elem_tile(M) if tile is None else tile, out.data_ptr(),
    )
    return out


def gather_chain(table, init, c: Optional[torch.Tensor], steps: int, mode: str):
    """G3: `gather_chain_plain` as the CUDA kernel on CUDA tensors; an initial
    state outside [0, N) raises.  The table may be a strided view: the pair
    plane's transpose `plane.T` makes each step of mode "sum" read one whole
    plane row, as K1 does."""
    if mode not in MODES:
        raise ValueError(f"gather_chain: mode {mode!r}, want one of {MODES}")
    dev = table.device
    W, N = table.shape
    if dev.type == "cpu":
        _check_range("gather_chain init", init, N)
        return gather_chain_plain(table, init, c, steps, mode)
    _check("table", table, dev, 2, contiguous=False)
    if N + steps >= 2**31 or steps < 0:
        raise ValueError(f"gather_chain: modulus {N} with {steps} steps")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if mode == "sum":
        _check("init", init, dev, 1)
        _check("c", c, dev, 1)
        return chain_sum(table, init, c, steps,
                         chain_plan(W, table.stride(0) == 1, init.numel(), sms))
    _check("init", init, dev, 2)
    if init.shape[0] != W:
        raise ValueError(f"gather_chain: init rows {init.shape[0]} != table rows {W}")
    return chain_elem(table, init, steps,
                      chain_elem_plan(W, N, table.stride(1), init.shape[1], sms))


# ---- G4: x * 2 -----------------------------------------------------------

def scale2_plain(x: torch.Tensor) -> torch.Tensor:
    """2 * x on int32, wrapping."""
    return _wrap32(x.to(torch.int64) * 2).to(torch.int32)


def scale2_plan(x_addr: int, buf_addr: int, n: int):
    """G4's layout of n int32 elements at byte address x_addr: (shift, head,
    nvec).  The output is buf[shift : shift + n] of a buffer of n + 3
    elements at buf_addr, so that it starts at x's offset within 16 bytes (a
    view such as x[1:] lies 4 bytes past a boundary).  Elements [head, head +
    4 nvec) of both are then 16-byte vectors, head reaching the first
    boundary; [0, head) and [head + 4 nvec, n) go one at a time."""
    if x_addr % 4 or buf_addr % 4:
        raise ValueError("scale2: int32 addresses must be 4-byte aligned")
    shift = (x_addr - buf_addr) % 16 // 4
    head = min(n, -x_addr % 16 // 4)
    return shift, head, (n - head) // 4


def scale2_out(x: torch.Tensor):
    """A new output for G4 on x, contiguous and of x's shape, at x's offset
    within 16 bytes, and G4's split: (out, head, nvec)."""
    n = x.numel()
    buf = torch.empty(n + 3, dtype=torch.int32, device=x.device)
    shift, head, nvec = scale2_plan(x.data_ptr(), buf.data_ptr(), n)
    return buf[shift: shift + n].view(x.shape), head, nvec


def scale2(x: torch.Tensor) -> torch.Tensor:
    """G4: `scale2_plain` as the CUDA kernel on CUDA tensors (into
    `scale2_out(x)`)."""
    if x.dtype != torch.int32 or not x.is_contiguous() or x.numel() == 0:
        raise ValueError(f"scale2: want a contiguous non-empty int32 tensor on {x.device}")
    dev = x.device
    if dev.type == "cpu":
        return scale2_plain(x)
    out, head, nvec = scale2_out(x)
    kernels.launch("scale2", dev, kernels.lib().siga_scale2,
                   x.data_ptr(), x.numel(), head, nvec, out.data_ptr())
    return out


# ---- the TPU probes' own calls --------------------------------------------

def probe_cases(rng: np.random.Generator, scale: int = 1):
    """Each Pallas probe kernel's call at its own shape, with every dimension
    except the widths divided by `scale` (tests cut them small):
    [(TPU kernel, 'file:line', wrapper name, args)] with numpy int32 inputs."""

    def ints(lo, hi, shape):
        return rng.integers(lo, hi, shape, dtype=np.int32)

    nb, q, r = 8192 // scale, 32768 // scale, 15872 // scale
    plane = ints(0, 1000, (r, 16))
    idx = ints(0, r, q)
    t8 = ints(0, 100, (8, 128))
    tc = ints(0, 100, (8, nb))
    ic = ints(0, nb, (8, nb))
    table24 = ints(0, 100, (24, nb))
    tiled = np.tile(plane, (-(-q // r), 1))[:q]
    return [
        ("main.g kernel k", "benchmark/probes/probe2.py:67", "scale2",
         (ints(-2**31, 2**31 - 1, (8, 128)),)),
        ("k_lane", "benchmark/probes/probe_gather.py:147", "take_along",
         (table24, ints(0, nb, (1, nb)), 1)),
        ("k_sub", "benchmark/probes/probe_gather.py:174", "gather_rows",
         (ints(0, 100, (nb, 128)), ints(0, nb, nb))),
        ("k_scan", "benchmark/probes/probe_gather.py:201", "gather_chain",
         (table24, np.zeros(nb, np.int32), ints(0, nb, 64), 112, "sum")),
        ("k_a", "benchmark/probes/probe3.py:121", "take_along",
         (t8, ints(0, 128, (8, 128)), 1)),
        ("k_b", "benchmark/probes/probe3.py:138", "take_along",
         (t8, ints(0, 8, (8, 128)), 0)),
        ("k_c", "benchmark/probes/probe3.py:155", "take_along", (tc, ic, 1)),
        ("k_d", "benchmark/probes/probe3.py:173", "gather_chain", (tc, ic, None, 100, "elem")),
        ("k1", "benchmark/probes/pallas_gather.py:48", "gather_rows", (plane, idx)),
        ("k2", "benchmark/probes/pallas_gather.py:72", "take_along",
         (np.ascontiguousarray(plane.T), idx[None, :], 1)),
        ("k3", "benchmark/probes/pallas_gather.py:95", "gather_rows", (plane, idx)),
        ("k4", "benchmark/probes/pallas_gather.py:148", "gather_rows", (tiled, idx)),
        ("k5", "benchmark/probes/pallas_gather.py:172", "gather_rows",
         (plane, idx[: 2048 // scale])),
    ]


def edge_cases(rng: np.random.Generator, device):
    """G1, G2, G3 and G4 at the shapes where a tiling, a group, a form or an
    alignment split can go wrong: [(label, wrapper name, args as tensors
    on `device`)].  G1: rows of C = 1, 12, 16, 57 and 128 words (words and
    16-byte vectors), row counts that fill no warp, more rows than one item
    a thread covers, planes 4 and 8 bytes off the 16-byte boundary.  G4: n
    of 1, 3, 4, 5, 1,023 and 4 * 2**20 + 3, and the view
    x[1:], 4 bytes off the 16-byte boundary.  G2: one table row, one output,
    output counts that fill no tile, rows wider than shared memory, the
    shared-memory form, both axes, and an index broadcast along each of its
    dimensions.  G3's mode sum: rows of W = 1, 24, 57 and 100 words,
    contiguous (a plane's transpose, also 4 bytes off its allocation) and
    strided, 1, 3 and 1,001 lanes (no multiple of a group), no steps, c of 1,
    5 and 64.  G3's mode elem: W = 1 and 8 rows of N = 1, 8,191, 8,192 and
    the words on each side of the shared-memory limit, 1, 3, 1,001 and 4,097
    lanes a row (no multiple of a tile), 0, 1 and 37 steps, a strided table
    and one 4 bytes off its allocation, full-range words and words near
    INT_MAX, initial states 0 and N - 1."""

    def ints(lo, hi, shape):
        return torch.from_numpy(rng.integers(lo, hi, shape, dtype=np.int64).astype(np.int32))

    def full(shape):
        return ints(-2**31, 2**31, shape)

    def rows_off(r, c, offset):  # a row-major [r, c] plane `offset` words into its allocation
        return full(r * c + offset).to(device)[offset:].view(r, c)

    gathers = [  # (label, plane, rows gathered)
        ("C=1", full((300, 1)), 1001),
        ("C=57 (a pair-plane row), 10,007 rows: several items a thread", full((999, 57)), 10_007),
        ("C=128", full((77, 128)), 301),
        ("C=16, rows no multiple of a warp's 8", full((500, 16)), 8 * 37 + 3),
        ("C=16, one row", full((500, 16)), 1),
        ("C=16, the plane 4 bytes off the 16-byte boundary", rows_off(500, 16, 1), 1003),
        ("C=12, the plane 8 bytes off the 16-byte boundary", rows_off(90, 12, 2), 515),
    ]
    cases = [(f"gather_rows {label}", "gather_rows", (plane, ints(0, plane.shape[0], q)))
             for label, plane, q in gathers]
    cases += [(f"scale2 n={n}", "scale2", (full(n),)) for n in (1, 3, 4, 5, 1023, 4 * 2**20 + 3)]
    cases.append(("scale2 x[1:] of 4,097", "scale2", (full(4097).to(device)[1:],)))
    wide = 60_001  # int32 words a row: more than shared memory holds (58,112)
    take = [
        ("A=1, axis 1", full((1, 300)), ints(0, 300, (1, 777)), 1),
        ("A=1, axis 0", full((1, 50)), ints(0, 1, (7, 50)), 0),
        ("Q=1, axis 1 (index [A, 1])", full((5, 40)), ints(0, 40, (5, 1)), 1),
        ("Q=1, axis 0 (index [1, B])", full((6, 33)), ints(0, 6, (1, 33)), 0),
        ("index [1, 1], axis 1", full((4, 9)), ints(0, 9, (1, 1)), 1),
        ("broadcast index [1, Q] off the tiles", full((37, 500)), ints(0, 500, (1, 8193)), 1),
        ("full index off the tiles", full((9, 777)), ints(0, 777, (9, 1025)), 1),
        ("axis 0, index [Q, 1] broadcast", full((8, 40)), ints(0, 8, (30, 1)), 0),
        ("axis 0 off the tiles", full((13, 301)), ints(0, 13, (17, 301)), 0),
        ("row wider than shared memory, full index", full((3, wide)), ints(0, wide, (3, 1000)), 1),
        ("row wider than shared memory, broadcast", full((2, wide)), ints(0, wide, (1, 5000)), 1),
        ("shared-memory form", full((140, 512)), ints(0, 512, (140, 520)), 1),
    ]
    cases += [(f"take_along {label}", "take_along", (t, i, axis)) for label, t, i, axis in take]

    def rows(nb, w, offset=0):  # the transpose of a row-major [nb, w] plane, `offset` words in
        return full(nb * w + offset).to(device)[offset:].view(nb, w).T

    chains = [  # (label, table [W, NB], lanes, steps, len(c))
        ("W=1 contiguous", rows(300, 1), 1, 37, 1),
        ("W=24 contiguous", rows(500, 24), 3, 37, 64),
        ("W=57 contiguous (a pair-plane row)", rows(1000, 57), 1001, 37, 64),
        ("W=57 contiguous, the plane 4 bytes in", rows(1000, 57, 1), 1001, 20, 5),
        ("W=100 contiguous (two rounds of vectors)", rows(400, 100), 3, 20, 64),
        ("W=1 strided", full((1, 300)), 3, 37, 1),
        ("W=24 strided (k_scan's table)", full((24, 1000)), 1001, 37, 64),
        ("W=57 strided", full((57, 700)), 1, 37, 5),
        ("W=40 strided (two rounds of words)", full((40, 333)), 1001, 20, 64),
        ("no steps", full((24, 1000)), 3, 0, 64),
    ]
    cases += [
        (f"gather_chain sum {label}, {lanes} lanes, {steps} steps", "gather_chain",
         (table, ints(0, table.shape[1], lanes), full(nc), steps, "sum"))
        for label, table, lanes, steps, nc in chains
    ]
    limit = SMEM_MAX // 4  # words of the longest row the shared form stages

    def ends(W, N, M):  # initial states 0 and N - 1, in turn
        return torch.tensor([0, N - 1], dtype=torch.int32).repeat(W, _cdiv(M, 2))[:, :M]

    elems = [  # (label, table [W, N], lanes a row, steps, initial states or None: random)
        ("k_d's shape [8, 8192]", full((8, 8192)), 8192, 100, None),
        ("W=1, N=1", full((1, 1)), 3, 37, None),
        ("W=8, N=1", full((8, 1)), 1001, 37, None),
        ("W=1, N=8192, one lane", full((1, 8192)), 1, 37, None),
        ("W=8, N=8192, lanes no multiple of a tile", full((8, 8192)), 1001, 37, None),
        ("W=8, N=8192, 9 tiles a row, the last of one lane", full((8, 8192)), 4097, 37, None),
        (f"N={limit}, the longest row shared memory holds", full((8, limit)), 14_529, 5, None),
        (f"N={limit + 1}, past shared memory", full((8, limit + 1)), 14_529, 5, None),
        ("no steps", full((8, 8192)), 4097, 0, None),
        ("one step", full((8, 8192)), 4097, 1, None),
        ("strided (a plane's transpose)", rows(8192, 8), 4097, 37, None),
        ("the table 4 bytes off its allocation", rows_off(8, 8192, 1), 4097, 37, None),
        ("W=8, N=8191 (no power of two)", full((8, 8191)), 8192, 100, None),
        ("N=8191, words near INT_MAX (sums that wrap)", ints(2**31 - 20_000, 2**31, (8, 8191)),
         4097, 37, None),
        ("N=8192, words near INT_MAX (sums that wrap)", ints(2**31 - 20_000, 2**31, (8, 8192)),
         4097, 37, None),
        ("initial states 0 and N - 1", full((8, 8192)), 4097, 37, ends(8, 8192, 4097)),
    ]
    cases += [
        (f"gather_chain elem {label}, {M} lanes a row, {steps} steps", "gather_chain",
         (table, ints(0, table.shape[1], (table.shape[0], M)) if init is None else init, None,
          steps, "elem"))
        for label, table, M, steps, init in elems
    ]
    return [
        (label, name, tuple(a.to(device) if isinstance(a, torch.Tensor) else a for a in args))
        for label, name, args in cases
    ]


def launch_floor(device) -> None:
    """One launch of an empty kernel (`siga_launch_floor`, one thread that
    does nothing): timed by `cuda_ms` as the kernels are, the least time a
    kernel's row of the table can show."""
    kernels.launch("launch_floor", torch.device(device), kernels.lib().siga_launch_floor)


# name -> (wrapper, plain version)
WRAPPERS = {
    "gather_rows": (gather_rows, gather_rows_plain),
    "take_along": (take_along, take_along_plain),
    "gather_chain": (gather_chain, gather_chain_plain),
    "scale2": (scale2, scale2_plain),
}


def to_device(args, device):
    """Numpy arrays of a probe case's args -> tensors on `device`."""
    return tuple(
        torch.from_numpy(np.ascontiguousarray(a)).to(device) if isinstance(a, np.ndarray) else a
        for a in args
    )


# ---- timing on the pair plane ---------------------------------------------

HOLD_CYCLES = 40_000_000  # ~20 ms of the card's clock


def cuda_ms(fn, reps: int) -> float:
    """Mean ms of fn() over reps runs after one warm-up, by CUDA events.  The
    card is held busy while the runs are enqueued, so a kernel shorter than
    the host's launch overhead is timed by its device work and not by the
    host's gaps between launches (a function that synchronises inside, or
    enqueues for longer than the hold, still times its gaps)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def plane_args(plane: torch.Tensor, lanes: int, steps: int, seed: int):
    """Each probe's arguments on the pair plane, with `lanes` uniformly random
    rows made on the plane's device from `seed`: G1 reads the rows, G2 the
    same rows from the transposed plane, G3 chains from them over whole rows
    (mode sum on `plane.T`), G4 streams the plane."""
    gen = torch.Generator(device=plane.device).manual_seed(seed)
    rows, c = (
        torch.randint(0, plane.shape[0], (k,), generator=gen, device=plane.device,
                      dtype=torch.int32)
        for k in (lanes, 64)
    )
    return {
        "gather_rows": (plane, rows),
        "take_along": (plane.T.contiguous(), rows[None, :], 1),
        "gather_chain": (plane.T, rows, c, steps, "sum"),
        "scale2": (plane,),
    }


def measure_plane(plane: torch.Tensor, lanes: int, steps: int, seed: int, reps: int = 20):
    """Times of G1-G4 through their wrappers on the pair plane (int32 [R, 57]
    on a card); every timed call is a counted launch."""
    if plane.device.type != "cuda":
        raise RuntimeError("the gather probes time kernels on a card; got " + str(plane.device))
    R, C = plane.shape
    row_bytes = lanes * C * 4
    ms = {}
    for name, args in plane_args(plane, lanes, steps, seed).items():
        wrapper, _plain = WRAPPERS[name]
        ms[name] = cuda_ms(lambda: wrapper(*args), reps if name != "gather_chain" else 5)
    g1, g2, g3, g4 = (ms[k] for k in ("gather_rows", "take_along", "gather_chain", "scale2"))
    return {
        "plane_rows": R, "plane_cols": C, "lanes": lanes, "steps": steps,
        "gather_rows_ms": g1, "gather_rows_GBps": row_bytes / g1 / 1e6,
        "take_along_ms": g2, "take_along_GBps": row_bytes / g2 / 1e6,
        "gather_chain_ms": g3, "gather_chain_ns_per_step": g3 * 1e6 / steps,
        "scale2_ms": g4, "scale2_GBps": 2 * plane.numel() * 4 / g4 / 1e6,
    }


def stacked_plane(prefix: str, device) -> torch.Tensor:
    """The overlap scan's stacked pair plane (forward rows, then reverse rows)
    of the index PREFIX.bwt / PREFIX.rbwt."""
    from ..constants import BWT_EXT, RBWT_EXT
    from ..index.fm import FMIndex

    from ..ops.fm_device import DeviceFM, DualScanner

    fwd, rev = (DeviceFM(FMIndex.load(prefix + ext), device) for ext in (BWT_EXT, RBWT_EXT))
    return DualScanner(fwd, rev, pair_step=True).plane


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m siga_tpu_torch.probes.gather",
        description="Time the gather probes G1-G4 on an index's pair plane (needs a card).",
    )
    parser.add_argument("--plane", required=True, metavar="PREFIX",
                        help="index prefix (PREFIX.bwt and PREFIX.rbwt)")
    parser.add_argument("--lanes", type=int, default=60608,
                        help="lanes, as in one overlap chunk (default 60608)")
    parser.add_argument("--steps", type=int, default=150, help="chain steps (default 150)")
    parser.add_argument("--seed", type=int, default=1)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the gather probes need a CUDA device")
    plane = stacked_plane(args.plane, torch.device("cuda"))
    result = measure_plane(plane, args.lanes, args.steps, args.seed)
    result["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
