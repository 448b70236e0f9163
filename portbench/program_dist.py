"""The spans of the program's distributed index build (K8) in a reduced
trace (`trace.Trace`), as `program.py` reads those of the one-card build.

`siga_tpu_torch/parallel/dist_build.py` names a build `siga.dist.build` and
its parts `siga.dist.<step>`.  One host process drives every card, so each
span is on the host's one timeline.  A window whose units recorded no
distributed build (K6 took every text alone, or a program without K8's
spans) gives None.
"""
from __future__ import annotations

import bisect

from portbench.program import spans

BUILD = "siga.dist.build"


def unit_seconds(t, names) -> list | None:
    """Each unit's seconds inside the program's spans named `names`, summed
    (a unit holds both directions of a build).  None without a trace or
    where the program recorded no distributed build."""
    if t is None:
        return None
    found = spans(t)
    if not any(name == BUILD for _s, _e, name in found):
        return None
    unit_starts = [s for s, _e in t.spans]
    out = [0.0] * len(t.spans)
    for s, e, name in found:
        i = bisect.bisect_right(unit_starts, s) - 1
        if name in names and i >= 0 and s < t.spans[i][1]:
            out[i] += (e - s) / 1e6
    return out
