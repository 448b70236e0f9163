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


def _launch(name: str, rc: int) -> None:
    """Raise on a failed launch, else count it."""
    kernels.check(rc, name)
    kernels.launches[name] += 1


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
    _launch("gather_rows", kernels.lib().siga_gather_rows(
        plane.data_ptr(), idx.data_ptr(), R, Q, C, out.data_ptr(), kernels.stream_ptr(dev),
    ))
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


def take_along(table: torch.Tensor, index: torch.Tensor, axis: int) -> torch.Tensor:
    """G2: `take_along_plain` as the CUDA kernel on CUDA tensors; an index
    outside the table's extent along `axis` raises."""
    dev = table.device
    shape = _take_shape(table, index, axis)
    if dev.type == "cpu":
        _check_range("take_along index", index, table.shape[axis])
        return take_along_plain(table, index, axis)
    _check("table", table, dev, 2)
    _check("index", index, dev, 2)
    A, B = table.shape
    # stride 0 along a broadcast dimension
    si0 = index.shape[1] if index.shape[0] > 1 else 0
    si1 = 1 if index.shape[1] > 1 else 0
    Q = shape[1] if axis == 1 else shape[0]
    out = torch.empty(shape, dtype=torch.int32, device=dev)
    _launch("take_along", kernels.lib().siga_take_along(
        table.data_ptr(), index.data_ptr(), A, B, Q, si0, si1, axis,
        out.data_ptr(), kernels.stream_ptr(dev),
    ))
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
    sw, sx = table.stride()
    lib, stream = kernels.lib(), kernels.stream_ptr(dev)
    out = torch.empty_like(init)
    if mode == "sum":
        _check("init", init, dev, 1)
        _check("c", c, dev, 1)
        rc = lib.siga_gather_chain_sum(
            table.data_ptr(), sw, sx, W, N, init.data_ptr(), c.data_ptr(), c.numel(),
            steps, init.numel(), out.data_ptr(), stream,
        )
    else:
        _check("init", init, dev, 2)
        if init.shape[0] != W:
            raise ValueError(f"gather_chain: init rows {init.shape[0]} != table rows {W}")
        rc = lib.siga_gather_chain_elem(
            table.data_ptr(), sw, sx, W, N, init.data_ptr(), init.shape[1], steps,
            out.data_ptr(), stream,
        )
    _launch("gather_chain", rc)
    return out


# ---- G4: x * 2 -----------------------------------------------------------

def scale2_plain(x: torch.Tensor) -> torch.Tensor:
    """2 * x on int32, wrapping."""
    return _wrap32(x.to(torch.int64) * 2).to(torch.int32)


def scale2(x: torch.Tensor) -> torch.Tensor:
    """G4: `scale2_plain` as the CUDA kernel on CUDA tensors."""
    dev = x.device
    if dev.type == "cpu":
        return scale2_plain(x)
    if x.dtype != torch.int32 or not x.is_contiguous() or x.numel() == 0:
        raise ValueError(f"scale2: want a contiguous non-empty int32 tensor on {dev}")
    out = torch.empty_like(x)
    _launch("scale2", kernels.lib().siga_scale2(
        x.data_ptr(), x.numel(), out.data_ptr(), kernels.stream_ptr(dev)
    ))
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
    return DualScanner(fwd, rev).plane


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
