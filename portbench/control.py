"""Readings for the limits of a cell's check, on the card at the cell's own
size: the program's sound readings over many seeds, and its control's.

    python3 -m portbench.control --workload NAME --sound S1,S2,... --control C1,C2,...

For each sound seed: the cell's set-up, one unit of the program, the check
against the plain reference.  For each control seed: the cell's set-up and
the control (the reference with one guarantee of the configuration broken,
in the program's place: `Cell.control`), judged by the same check.  Prints
each reading and, last, a JSON object with the largest sound reading and
the smallest control reading of each number compared.  The benchmark's own
runs never run the control.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import harness  # noqa: E402


def seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--sound", type=seeds, default=[])
    p.add_argument("--control", type=seeds, default=[])
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("portbench.control: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    bench = harness.load_benchmark()
    cell = harness.workload(bench, args.workload)
    mix = harness.traffic(cell["traffic"])
    cfg = harness.config(bench, cell["config"])
    make = harness.entry(mix["entry"]).Cell
    readings = {"sound": {}, "control": {}}
    for kind, seed in [("sound", s) for s in args.sound] + [("control", s) for s in args.control]:
        t0 = time.time()
        c = make(cfg, mix, seed, device, 1.0)
        if kind == "sound":
            c.keep(0, c.unit())
            c.release()
            torch.cuda.empty_cache()
            compared, _failed = c.check()
        else:
            c.release()
            torch.cuda.empty_cache()
            compared = c.control()
        for name, value, _limit in compared:
            readings[kind].setdefault(name, []).append(value)
        print(f"{args.workload} {kind} seed {seed}: "
              + ", ".join(f"{n} {v}" for n, v, _ in compared) + f" ({time.time() - t0:.1f} s)",
              flush=True)
        del c
        torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "card": harness.card_line(),
                      "sound_max": {n: max(v) for n, v in readings["sound"].items()},
                      "control_min": {n: min(v) for n, v in readings["control"].items()},
                      "readings": readings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
