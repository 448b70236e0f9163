"""The distributed index build (K8, `parallel/dist_build.py`) over distinct
cards, held to the device suffix sort (K6) on the first.

    python -m siga_tpu_torch.probes.dist_cards [--reads N]

Segments on different cards take the paths that `[cuda:0] * D` never
takes: each exchange's pieces are copied between cards, and a numbering
writes the rank tables of the other cards through peer access, the streams
joined without a host wait.  For each device list of `device_lists` (D = 2
and 4 distinct cards where there are four, and each card twice for D = 8)
and each text (the read sets of `texts`: one doubling round, two rounds
with a tied group, identical reads, and N reads of 150 bp from both strands
of a random genome of N * 6 bp), the build's SA, BWT and permutation must
equal K6's on the first card, and each step it ran (`dist_build.STEPS`,
recorded) must equal its plain version on the same inputs bit for bit.
For the N-read text it also prints the host waits (the build's count) and
the warm walls of `distributed_bwt_perm` over the list and over the first
card D times, in turn; the last line names the cards and their power
limits.  On a host with fewer than two cards it raises.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

from ..index import sa
from ..parallel import dist_build
from .kernel_ab import host_walls

SEED = 1
READ_LEN = 150
WALL_REPS = 5


def genome_reads(n: int, seed: int = SEED) -> list:
    """n reads of READ_LEN from both strands of a random genome of 6 n bp
    (25x coverage)."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, max(6 * n, 2 * READ_LEN))
    starts = rng.integers(0, genome.size - READ_LEN + 1, n)
    codes = genome[starts[:, None] + np.arange(READ_LEN)]
    flip = rng.random(n) < 0.5
    codes[flip] = 3 - codes[flip, ::-1]
    return ["".join("ACGT"[c] for c in row) for row in codes]


def texts(n: int, seed: int = SEED) -> dict:
    """{label: reads}: small read sets that meet the build's edges, and n
    genome reads."""
    rng = np.random.default_rng(seed)
    return {
        "one round (100 bp)": ["".join("ACGT"[c] for c in rng.integers(0, 4, 100))
                               for _ in range(60)],
        "two rounds, one tied group (40 x 200 A)": ["A" * 200] * 40,
        "identical reads": ["ACGTTGCAAC" * 9] * 6,
        f"{n} genome reads of {READ_LEN} bp": genome_reads(n, seed),
    }


def device_lists(cards: int) -> list:
    """D = 2 and 4 distinct cards (as many as there are), and every card
    twice."""
    names = [f"cuda:{k}" for k in range(cards)]
    lists = [names[:d] for d in (2, 4) if d <= cards]
    return lists + [names[: 1 << (cards.bit_length() - 1)] * 2]


def check(codes: np.ndarray, devices, first) -> dict:
    """K8 of `codes` over `devices` against K6 on `first`: {"equal": bool,
    "steps": {label: bool}, "host_syncs": int}."""
    want_sa = sa.suffix_array_device(codes, first).cpu().numpy()
    want_bwt, want_perm = sa.bwt_perm_device(codes, first)
    record = {}
    outs, stats = dist_build.run_distributed(codes, devices, True, record)
    packed = torch.cat([o.to(first) for o in outs]).cpu()
    sym = (packed & 7).to(torch.uint8)
    equal = (np.array_equal(sym.numpy(), want_bwt)
             and np.array_equal((packed[sym == 0] >> 3).numpy(), want_perm)
             and np.array_equal(dist_build.distributed_sa(codes, devices), want_sa))
    steps = {}
    for label, (name, args) in record.items():
        wrapper, plain = dist_build.STEPS[name]
        got, want = dist_build._copy(args), dist_build._copy(args)
        outs_got = dist_build.step_outputs(name, got, wrapper(*got))
        outs_want = dist_build.step_outputs(name, want, plain(*want))
        steps[label] = all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(outs_got, outs_want,
                                                                         strict=True))
    return {"equal": bool(equal), "steps": steps, "host_syncs": stats["host_syncs"]}


def walls(codes: np.ndarray, devices) -> dict:
    """Warm walls (ms: median, min, max) of `distributed_bwt_perm` over
    `devices` and over its first entry len(devices) times, in turn."""
    one = [devices[0]] * len(devices)
    out = {}
    for label, wall in zip(("over the list", "over the first card"), host_walls(
            [lambda: dist_build.distributed_bwt_perm(codes, devices),
             lambda: dist_build.distributed_bwt_perm(codes, one)], WALL_REPS)):
        ms = sorted(w * 1e3 for w in wall)
        out[label] = [float(np.median(ms)), ms[0], ms[-1]]
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m siga_tpu_torch.probes.dist_cards",
                                     description=__doc__.split("\n\n")[0])
    parser.add_argument("--reads", type=int, default=166_667,
                        help="genome reads of the large text (default: chip_smoke's 1 Mb x 25x)")
    args = parser.parse_args(argv)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < 2:
        raise SystemExit(f"dist_cards needs two cards or more; this host has {cards}")
    first = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=False)
    result = {"cards": smi.stdout.strip().splitlines() or
              [torch.cuda.get_device_name(k) for k in range(cards)], "cases": []}
    large = f"{args.reads} genome reads of {READ_LEN} bp"
    for label, reads in texts(args.reads).items():
        codes = sa.concat_reads(reads)[0]
        for devices in device_lists(cards):
            case = {"text": label, "chars": int(codes.size), "devices": devices,
                    **check(codes, devices, first)}
            if label == large and len(set(devices)) == len(devices):
                case["walls_ms"] = walls(codes, devices)
            print(json.dumps(case), flush=True)
            result["cases"].append(case)
            if not case["equal"] or not all(case["steps"].values()):
                raise SystemExit(f"K8 over {devices} on {label} differs from K6 or a step "
                                 f"from its plain version")
    print(json.dumps({"ok": True, "cases": len(result["cases"]), "cards": result["cards"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
