"""Where the time of the plane build K2 goes, on one card.

    python3 -m siga_tpu_torch.probes.plane_phases --index PREFIX

Builds two copies of `csrc/pair_plane.cu`, each with one change to its
source, and times them beside the kernel itself on the BWT codes of
PREFIX.bwt (an index as `index` writes it):
  - `no_wait`: the decoupled look-back returns at once, so a tile never
    waits on the tiles before it (the counts before every tile read as 0:
    the output is wrong, and every address stays inside the codes);
  - `phases`: thread 0 of every tile stores the global timer when each
    phase of the kernel begins (the `// PHASE 1:` ... `// PHASE 7:` marks
    of its source) and when the tile ends.
Prints the three walls (CUDA events, REPS builds a timing, ROUNDS timings
of each in turn), and from `phases` the median time of each phase over the
tiles that started after the first third of the build, beside the
kernel's span and the mean number of tiles in flight.  Needs a card and
nvcc; a source that no longer has the anchors the changes need makes it
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
from ..index.fm import SAMPLE, FMIndex
from ..ops import fm_device
from .gather import cuda_ms

SOURCE = os.path.join(kernels.CSRC, "pair_plane.cu")
PHASES = 7  # the marked phases of the kernel; one more mark at its end
REPS = 20  # builds a timing
ROUNDS = 5  # timings of each copy, in turn
PROBE_HEADER = """
__device__ unsigned long long* probe_marks;
__device__ __forceinline__ void probe_mark(int tile, int k) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  probe_marks[static_cast<size_t>(tile) * 8 + k] = t;
}
"""
PROBE_ENTRY = """
extern "C" int probe_set_marks(void* p) {
  return static_cast<int>(cudaMemcpyToSymbol(probe_marks, &p, sizeof(p)));
}
"""


def _once(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise RuntimeError(f"pair_plane.cu: want one {old!r} to change, found {text.count(old)}")
    return text.replace(old, new)


def no_wait(text: str) -> str:
    return _once(text, "  if (tile == 0) return base;\n", "  return base;\n")


def phases(text: str) -> str:
    text = _once(text, "namespace {\n", "namespace {\n" + PROBE_HEADER)
    for k in range(1, PHASES + 1):
        mark = f"\n  // PHASE {k}: "
        text = _once(text, mark, f"\n  if (threadIdx.x == 0) probe_mark(tile, {k - 1});{mark}")
    end = re.search(r"\n}\n\n}  // namespace", text)
    if end is None:
        raise RuntimeError("pair_plane.cu: no end of the kernel before the namespace's end")
    text = (text[: end.start()] + "\n  __syncthreads();\n  if (threadIdx.x == 0) "
            f"probe_mark(tile, {PHASES});" + text[end.start():])
    return text + PROBE_ENTRY


def build(name: str, change) -> ctypes.CDLL:
    """The kernel's source with `change` applied, compiled alone."""
    out_dir = os.path.join(BUILD_DIR, "plane_phases")
    os.makedirs(out_dir, exist_ok=True)
    src, lib = os.path.join(out_dir, f"{name}.cu"), os.path.join(out_dir, f"{name}.so")
    with open(SOURCE) as f, open(src, "w") as g:
        g.write(change(f.read()))
    proc = subprocess.run([kernels.nvcc(), *kernels.NVCC_FLAGS, "-shared", "-I", kernels.CSRC,
                           "-o", lib, src], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc {name} failed ({proc.returncode}):\n{proc.stderr}")
    handle = ctypes.CDLL(lib)
    for fn, argtypes in kernels._SIGNATURES.items():
        if fn.startswith("siga_pair_plane"):
            getattr(handle, fn).argtypes = argtypes
            getattr(handle, fn).restype = ctypes.c_int
    if name == "phases":
        handle.probe_set_marks.argtypes = [ctypes.c_void_p]
        handle.probe_set_marks.restype = ctypes.c_int
    return handle


def launcher(lib, codes, pred, nblocks):
    """One build through `lib`'s C entry, allocating and launching as the
    wrapper does (each build counts as a `pair_plane` launch)."""
    def run():
        plane = torch.empty((nblocks, fm_device.PAIR_COLS), dtype=torch.int32, device=codes.device)
        K = torch.empty((5, 5), dtype=torch.int32, device=codes.device)
        scratch = torch.empty(lib.siga_pair_plane_scratch(nblocks), dtype=torch.int32,
                              device=codes.device)
        kernels.launch("pair_plane", codes.device, lib.siga_pair_plane, codes.data_ptr(),
                       codes.numel(), nblocks, *(int(p) for p in pred), plane.data_ptr(),
                       K.data_ptr(), scratch.data_ptr())
        return plane, K
    return run


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python3 -m siga_tpu_torch.probes.plane_phases",
                                     description=__doc__.split("\n\n")[0])
    parser.add_argument("--index", required=True, help="index prefix (PREFIX.bwt)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("plane_phases needs a card")
    dev = torch.device("cuda")
    fmi = FMIndex.load(args.index + ".bwt")
    codes = torch.from_numpy(np.ascontiguousarray(fmi.codes)).to(dev)
    pred = np.asarray(fmi.pred, dtype=np.int64)
    nblocks = fmi.length // SAMPLE + 1
    runs = {
        "kernel": lambda: fm_device.build_pair_plane(codes, pred, nblocks),
        "no_wait": launcher(build("no_wait", no_wait), codes, pred, nblocks),
    }
    probe = build("phases", phases)
    marks = torch.zeros(nblocks * (PHASES + 1), dtype=torch.int64, device=dev)  # a row a tile, at most
    kernels.check(probe.probe_set_marks(marks.data_ptr()), "probe_set_marks")
    runs["phases"] = launcher(probe, codes, pred, nblocks)
    want = runs["kernel"]()
    assert all(torch.equal(a, b) for a, b in zip(runs["phases"](), want)), "phases differs"
    walls = {name: [] for name in runs}
    for _ in range(ROUNDS):
        for name, fn in runs.items():
            walls[name].append(cuda_ms(fn, REPS))
    marks.zero_()
    runs["phases"]()
    torch.cuda.synchronize()
    m = marks.view(nblocks, PHASES + 1).cpu().numpy()
    m = m[m[:, 0] > 0]  # the tiles (a tile's marks are row `tile`)
    t = (m - m[:, :1].min()) / 1e3  # us from the first tile's start
    late = t[:, 0] >= np.percentile(t[:, 0], 100 / 3)
    steps = np.diff(t, axis=1)[late]
    span = float(t[:, PHASES].max())
    out = {
        "codes": fmi.length, "tiles": int(len(t)),
        "wall_ms": {k: float(np.median(v)) for k, v in walls.items()},
        "wall_ms_spread": {k: [float(min(v)), float(max(v))] for k, v in walls.items()},
        "phase_us_median": {f"phase {k + 1}": float(np.median(steps[:, k])) for k in range(PHASES)},
        "tile_us_median": float(np.median(t[late, PHASES] - t[late, 0])),
        "span_us": span,
        "tiles_in_flight": float((t[:, PHASES] - t[:, 0]).sum() / span),
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
