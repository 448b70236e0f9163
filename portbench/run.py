"""Run one cell of the benchmark of siga_tpu_torch on this machine's cards.

    python3 -m portbench.run --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout.  Prints the cell's end-to-end metrics (--trace
0) or its per-layer metrics and the breakdown of a `torch.profiler` trace of
the window (--trace 1), with `correct`, as one JSON object on the last line
of standard output; the numbers the check compared, each beside its limit,
are the last lines of standard error.  Exits with another code than 0, and
prints no result, without enough CUDA cards or where the JAX package or JAX
was loaded.
"""
import time

START = time.time()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = harness.load_benchmark()
    cell = harness.workload(bench, args.workload)

    import torch

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA card(s); this machine has "
              f"{cards}", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    result = harness.run(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                         torch.device("cuda", 0), START)
    banned = harness.banned_modules()
    if banned:
        print(f"portbench: the run loaded {', '.join(banned)}", file=sys.stderr)
        return 3
    harness.finish(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
