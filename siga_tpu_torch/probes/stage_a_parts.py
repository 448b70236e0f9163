"""Where the time of the stage-A scan K9 goes, on one card.

    python3 -m siga_tpu_torch.probes.stage_a_parts [--tree DIR]

Indexes the reads of `chip_smoke.py`'s main path (166,667 error-free 150 bp
reads of a random 1 Mb genome, both strands, seed 1) on the card and runs
K9 on the first 60,608 of them (ID lanes, 149 steps, -m 45) over the
forward single-step plane, as `chip_smoke.py` times it.  It builds copies
of DIR/siga_tpu_torch/csrc/stage_a.cu (default: this checkout's), each
with one change to its source, and times them beside the unchanged source
compiled the same way:
  - `no_stores`: the records and valid bytes never reach device memory
    (their stores sit behind a condition that never holds, so everything
    they need is still computed);
  - `chars_transposed`: the chars are read from a transposed copy
    [max_t + 1, L], so a warp's symbols of a step lie side by side
    (the outputs stay right);
  - `fixed_row`: every step's row reads go to plane row 0 (row >> 30: the
    address still waits on the chain, the counts still run; the outputs
    are wrong, every address stays inside the plane);
  - `other_fetch` (the tiled design only): the other row fetch, one
    thread a lane against the warp's cooperative fetch;
  - `no_stores+chars_transposed+fixed_row`: all three at once.
Each design's anchors are its own: one thread a lane with every access its
own (PR 16), one thread a lane with per-warp buffers in shared memory
(`tiled`, commit cf411cd), two threads a lane with the records through
shared memory (`pair-staged`, commit 5b67bbc) or without (`pair`, the
kernel since).
Prints one JSON line: each copy's median time (CUDA events, REPS calls a
timing, ROUNDS timings of each in turn) and spread, whether the copies
whose outputs stay right equal `scan_stage_a_plain`, and the instructions
of the kernel's longest loop (its live steps) by the unit that runs them,
from `cuobjdump -sass` of each copy (`step_instructions`).  Needs a card and
nvcc; a source that lacks an anchor its design's changes need makes it
fail.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess

import numpy as np
import torch

from .. import kernels
from ..device import BUILD_DIR
from ..index import sa
from ..index.fm import FMIndex
from ..ops import fm_device
from .gather import cuda_ms

SEED, GENOME, COVERAGE, READ_LEN = 1, 1_000_000, 25, 150  # chip_smoke.py's main path
LANES, MIN_OVERLAP = 60_608, 45  # one overlap chunk's lanes, the main path's -m
REPS = 20  # calls a timing
ROUNDS = 5  # timings of each copy, in turn

# (old, new) anchors of each change, by design
_TRANSPOSED_FIRST = [
    ("  const int* chars = a.chars + static_cast<size_t>(lane) * (a.max_t + 1);",
     "  const int* chars = a.chars + lane;  // transposed: [max_t + 1, L]"),
    ("  const int c0 = __ldg(chars + a.max_t);",
     "  const int c0 = __ldg(chars + static_cast<size_t>(a.max_t) * a.L);"),
    ("__ldg(chars + t + 1)", "__ldg(chars + static_cast<size_t>(t + 1) * a.L)"),
]
_TRANSPOSED_TILED = [
    ("  const size_t row_words = static_cast<size_t>(max_t) + 1;",
     "  const size_t row_words = a.L;  // transposed: [max_t + 1, L]"),
    ("  const int* chars = a.chars + static_cast<size_t>(lane0) * row_words;",
     "  const int* chars = a.chars + lane0;"),
    ("    const int c0 = __ldg(chars + k * row_words + max_t);",
     "    const int c0 = __ldg(chars + max_t * row_words + k);"),
    ("    const int lane = f / kTile, w = f % kTile;", "    const int lane = f % 32, w = f / 32;"),
    ("chars + lane * row_words + t0 + w)", "chars + (t0 + w) * row_words + lane)"),
]
_FIXED_ROW = [
    ("load_below(plane, wq[0].row, ", "load_below(plane, wq[0].row >> 30, "),
    ("load_below(plane, wq[1].row, ", "load_below(plane, wq[1].row >> 30, "),
]
_NO_STORES_FIRST = [
    ("    em[0] = lo;\n    em[1] = rlo;\n    em[2] = hi - lo;\n    *va = ok ? 1 : 0;\n",
     "    if (a.L < 0) {\n      em[0] = lo;\n      em[1] = rlo;\n      em[2] = hi - lo;\n"
     "      *va = ok ? 1 : 0;\n    }\n"),
    ("    em[0] = lo;\n    em[1] = rlo;\n    em[2] = hi - lo;\n    *va = 0;\n",
     "    if (a.L < 0) {\n      em[0] = lo;\n      em[1] = rlo;\n      em[2] = hi - lo;\n"
     "      *va = 0;\n    }\n"),
]
_FROZEN_STORES = ("    if (side == 0) {\n      em[0] = lo;\n      em[1] = rlo;\n    } else {\n"
                  "      em[0] = hi - lo;\n      *va = 0;\n    }\n")
_LIVE_STORES = _FROZEN_STORES.replace("*va = 0;", "*va = ok ? 1 : 0;")
_TRANSPOSED_PAIR = [
    ("  const int c0 = __ldg(chars + max_t);",
     "  const int c0 = __ldg(chars + static_cast<size_t>(max_t) * a.L);"),
    ("__ldg(chars + t + 1)", "__ldg(chars + static_cast<size_t>(t + 1) * a.L)"),
]
_NO_TILE_WRITES = [("    write_tile(b, a, lane0, nl, t0, n, k);",
                    "    if (a.L < 0) write_tile(b, a, lane0, nl, t0, n, k);")]
DESIGNS = {
    "pair": {
        "no_stores": [(old, "    if (a.L < 0) {\n" + old + "    }\n")
                      for old in (_LIVE_STORES, _FROZEN_STORES)],
        "chars_transposed": [
            ("  const int* chars = a.chars + static_cast<size_t>(lane) * (max_t + 1);",
             "  const int* chars = a.chars + lane;  // transposed: [max_t + 1, L]"),
        ] + _TRANSPOSED_PAIR,
        "fixed_row": [("    load_below(plane, q.row, q.tail, row);",
                       "    load_below(plane, q.row >> 30, q.tail, row);")],
    },
    "pair-staged": {
        "no_stores": _NO_TILE_WRITES,
        "chars_transposed": [
            ("  const int* chars = a.chars + static_cast<size_t>(here ? lane : lane0) * (max_t + 1);",
             "  const int* chars = a.chars + (here ? lane : lane0);  // transposed: [max_t + 1, L]"),
        ] + _TRANSPOSED_PAIR,
        "fixed_row": [("          load_below(plane, q.row, q.tail, row);",
                       "          load_below(plane, q.row >> 30, q.tail, row);")],
    },
    "one-thread": {
        "no_stores": _NO_STORES_FIRST,
        "chars_transposed": _TRANSPOSED_FIRST,
        "fixed_row": _FIXED_ROW,
    },
    "tiled": {
        "no_stores": _NO_TILE_WRITES,
        "chars_transposed": _TRANSPOSED_TILED,
        "fixed_row": _FIXED_ROW + [("plane.row(r) + (k & 3)", "plane.row(r >> 30) + (k & 3)")],
        "other_fetch": [("constexpr bool kCoopRows = true;", "constexpr bool kCoopRows = false;")],
    },
}
RIGHT = ("kernel", "chars_transposed", "other_fetch")  # copies whose outputs equal the plain version's
COMBINED = ("no_stores", "chars_transposed", "fixed_row")


def design(text: str) -> str:
    """The design of a stage_a.cu source: 'pair' (two threads a lane, one
    a row), 'pair-staged' (the same with its records through shared
    memory), 'tiled' (one thread a lane, per-warp buffers in shared memory)
    or 'one-thread' (every access a lane's own)."""
    if "struct WarpTile" in text:
        return "pair-staged"
    if "const int lane = g >> 1, side = g & 1;" in text:
        return "pair"
    return "tiled" if "struct WarpBuffers" in text else "one-thread"


def changes(text: str) -> dict:
    """{copy name: [(old, new), ...]} of the copies this source's design has,
    the unchanged 'kernel' included."""
    own = DESIGNS[design(text)]
    out = {"kernel": [], **own}
    out["+".join(COMBINED)] = [pair for name in COMBINED for pair in own[name]]
    return out


def changed(text: str, pairs) -> str:
    """The source with each (old, new) made, each old found exactly once."""
    for old, new in pairs:
        if text.count(old) != 1:
            raise RuntimeError(f"stage_a.cu: want one {old!r} to change, found {text.count(old)}")
        text = text.replace(old, new)
    return text


# SASS opcodes by the unit that runs them (the rest: "other")
UNITS = {
    "alu": ("LOP3", "IADD3", "SHF", "ISETP", "SEL", "VIMNMX", "VIADDMNMX", "VIADD", "LEA", "PRMT",
            "BMSK", "PLOP3", "IABS", "FSEL", "P2R", "R2P", "SGXT", "FLO", "BREV"),
    "fma": ("IMAD", "IMUL", "FFMA", "FADD", "FMUL"),
    "popc": ("POPC",),
    "memory": ("LDG", "STG", "LDS", "STS", "LDGSTS", "SHFL", "LDC", "LD", "ST"),
}


def step_instructions(sass: str) -> dict:
    """{unit: count} of the instructions of the longest innermost loop (a
    span from a backward branch's target to the branch that holds no other
    such span: a design's step) of the first kernel in a `cuobjdump -sass`
    listing, with its total as "loop"."""
    code = []
    for line in sass.splitlines():
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)\s*(.*?);", line)
        if m:
            code.append((int(m.group(1), 16), m.group(2).split(".")[0], m.group(3)))
    where = {addr: i for i, (addr, _op, _rest) in enumerate(code)}
    loops = []
    for i, (addr, op, rest) in enumerate(code):
        target = re.search(r"0x([0-9a-f]+)", rest) if op == "BRA" else None
        if target and int(target.group(1), 16) < addr and int(target.group(1), 16) in where:
            loops.append((where[int(target.group(1), 16)], i))
    inner = [(e - s + 1, s, e) for s, e in loops
             if not any(s <= s2 and e2 <= e and (s2, e2) != (s, e) for s2, e2 in loops)]
    best = max(inner, default=(0, 0, -1))
    counts = {unit: 0 for unit in (*UNITS, "other")}
    for _addr, op, _rest in code[best[1]:best[2] + 1]:
        unit = next((u for u, ops in UNITS.items() if op in ops), "other")
        counts[unit] += 1
    return {"loop": best[0], **counts}


def build(tree: str, name: str, text: str) -> ctypes.CDLL:
    """`text` (a copy of TREE's stage_a.cu) compiled alone against TREE's
    headers."""
    out_dir = os.path.join(BUILD_DIR, "stage_a_parts")
    os.makedirs(out_dir, exist_ok=True)
    tag = name.replace("+", "_")
    src, lib = os.path.join(out_dir, f"{tag}.cu"), os.path.join(out_dir, f"{tag}.so")
    with open(src, "w") as f:
        f.write(text)
    csrc = os.path.join(tree, "siga_tpu_torch", "csrc")
    proc = subprocess.run([kernels.nvcc(), *kernels.NVCC_FLAGS, "-shared", "-I", csrc, "-o", lib,
                           src], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc {name} failed ({proc.returncode}):\n{proc.stderr}")
    handle = ctypes.CDLL(lib)
    entry = "siga_scan_stage_a"
    getattr(handle, entry).argtypes = kernels._SIGNATURES[entry]
    getattr(handle, entry).restype = ctypes.c_int
    handle.ptxas = [line.strip() for line in proc.stderr.splitlines()
                    if "registers" in line or "spill" in line]
    dump = subprocess.run([os.path.join(os.path.dirname(kernels.nvcc()), "cuobjdump"), "-sass", lib],
                          capture_output=True, text=True)
    handle.steps = step_instructions(dump.stdout) if dump.returncode == 0 else None
    return handle


def launcher(lib, args, transposed: bool):
    """One K9 call through `lib`'s C entry, allocating as the wrapper does;
    `transposed` passes the chars as [max_t + 1, L]."""
    max_t, mo, plane, pred, length, chars, lens, _tab = args
    L = chars.shape[0]
    if transposed:
        chars = chars.T.contiguous()

    def run():
        dev = plane.device
        out = (torch.empty((max_t, L, 3), dtype=torch.int32, device=dev),
               torch.empty((max_t, L), dtype=torch.bool, device=dev),
               torch.empty((L, 8), dtype=torch.int32, device=dev),
               torch.empty((L, 5), dtype=torch.int32, device=dev))
        kernels.launch("scan_stage_a", dev, lib.siga_scan_stage_a, plane.data_ptr(),
                       plane.shape[0], pred.data_ptr(), length, chars.data_ptr(), lens.data_ptr(),
                       None, L, max_t, mo, *(x.data_ptr() for x in out))
        return out
    return run


def simulated_reads(genome_len: int = GENOME, seed: int = SEED) -> list:
    """`chip_smoke.py`'s main-path reads: error-free READ_LEN bp reads at
    uniform positions of a random genome, at COVERAGE, half of them
    reverse-complemented."""
    rng = np.random.default_rng(seed)
    n = -(-genome_len * COVERAGE // READ_LEN)
    genome = rng.integers(0, 4, genome_len, dtype=np.uint8)
    starts = rng.integers(0, genome_len - READ_LEN + 1, n)
    codes = genome[starts[:, None] + np.arange(READ_LEN)]
    flip = rng.random(n) < 0.5
    codes[flip] = 3 - codes[flip, ::-1]
    letters = np.frombuffer(b"ACGT", dtype=np.uint8)[codes]
    return [row.tobytes().decode() for row in letters]


def stage_a_args(seqs, dev):
    """K9's arguments: the first LANES of `seqs` as lanes over the forward
    single-step plane of all of them, at -m MIN_OVERLAP."""
    from ..dryrun import stage_a_chars

    bwt, _perm, ns = sa.build_index_arrays(seqs, "sais2", dev)
    fm = fm_device.DeviceFM(FMIndex(bwt, ns), dev)
    chars, lens = stage_a_chars(seqs[:LANES])
    return (chars.shape[1] - 1, MIN_OVERLAP, fm.occ_plane, fm.pred_dev, fm.length,
            torch.from_numpy(chars).to(dev), torch.from_numpy(lens).to(dev), None)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python3 -m siga_tpu_torch.probes.stage_a_parts",
                                     description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", default=os.path.dirname(os.path.dirname(kernels.CSRC)),
                        help="the checkout whose csrc/stage_a.cu is split (default: this one)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("stage_a_parts needs a card")
    dev = torch.device("cuda")
    tree = os.path.abspath(args.tree)
    with open(os.path.join(tree, "siga_tpu_torch", "csrc", "stage_a.cu")) as f:
        text = f.read()
    k9 = stage_a_args(simulated_reads(), dev)
    want = fm_device.scan_stage_a_plain(*k9)
    runs, equal, ptxas, steps = {}, {}, {}, {}
    for name, pairs in changes(text).items():
        lib = build(tree, name, changed(text, pairs))
        ptxas[name], steps[name] = lib.ptxas, lib.steps
        runs[name] = launcher(lib, k9, "chars_transposed" in name)
        if name in RIGHT:
            equal[name] = all(torch.equal(a, b) for a, b in zip(runs[name](), want))
    times = {name: [] for name in runs}
    for _ in range(ROUNDS):
        for name, fn in runs.items():
            times[name].append(cuda_ms(fn, REPS))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(json.dumps({
        "tree": tree, "design": design(text), "card": card,
        "lanes": k9[5].shape[0], "steps": k9[0], "equal_to_plain": equal,
        "ms": {k: float(np.median(v)) for k, v in times.items()},
        "ms_spread": {k: [float(min(v)), float(max(v))] for k, v in times.items()},
        "ptxas": ptxas, "step_instructions": steps,
    }))
    if not all(equal.values()):
        raise SystemExit(f"a copy whose outputs should stay right differs from the plain version: {equal}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
