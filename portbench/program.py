"""The program's own spans in a reduced trace (`trace.Trace`).

`siga_tpu_torch.spans` records each span as a host operation of the
profiler's trace, named `siga.<layer>.<step>`: `Trace.host` holds them beside
the torch operations and CUDA runtime calls, on the trace's clock, and
`Trace.idle_gaps` names a gap by the spans that cover it.  This gives the
readers of the per-layer metrics each unit's seconds inside named spans,
whole or the part of them in which the device ran nothing.  A program that
records no build span (`BUILD`) gives None.
"""
from __future__ import annotations

import bisect

from portbench.trace import _covered

PREFIX = "siga."
BUILD = "siga.sa.build"
CHILDREN = ("siga.sa.check_fits", "siga.sa.pin_text", "siga.sa.seed", "siga.sa.sort_plan",
            "siga.sa.rounds", "siga.sa.to_host")


def spans(t) -> list:
    """[(start, end, name)] of the program's spans in the trace `t`."""
    return [h for h in t.host if h[2].startswith(PREFIX)]


def unit_seconds(t, names, idle: bool = False) -> list | None:
    """Each unit's seconds inside the program's spans named `names`, summed
    (a unit holds both directions of a build); with `idle`, only the part in
    which the device ran nothing.  None without a trace or where the program
    recorded no build."""
    if t is None:
        return None
    found = spans(t)
    if not any(name == BUILD for _s, _e, name in found):
        return None
    unit_starts = [s for s, _e in t.spans]
    busy_starts = [b[0] for b in t.busy]
    out = [0.0] * len(t.spans)
    for s, e, name in found:
        i = bisect.bisect_right(unit_starts, s) - 1
        if name not in names or i < 0 or s >= t.spans[i][1]:
            continue
        out[i] += ((e - s) - (_covered(t.busy, busy_starts, s, e) if idle else 0.0)) / 1e6
    return out
