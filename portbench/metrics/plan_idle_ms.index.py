"""plan_idle_ms.index: the part of the host's plan that the card does not
hide: the time inside the program's `siga.sa.sort_plan` spans in which the
device ran nothing (the seed's sorts are enqueued before the plan), both
directions summed, mean over the traced window's builds (ms).  Prints the
device's idle time a build inside each of the build's spans beside it."""
import sys

from portbench import program
from portbench.metrics import mean_ms


def read(ctx):
    t = ctx["trace"]
    value = mean_ms(program.unit_seconds(t, ("siga.sa.sort_plan",), idle=True))
    if value is not None:
        build = mean_ms(program.unit_seconds(t, (program.BUILD,), idle=True))
        parts = {n: mean_ms(program.unit_seconds(t, (n,), idle=True)) for n in program.CHILDREN}
        print(f"[portbench] device idle a build, mean: inside {program.BUILD} {build} ms; "
              + ", ".join(f"{n} {v}" for n, v in parts.items())
              + f"; outside them {build - sum(parts.values())} ms", file=sys.stderr)
    return value
