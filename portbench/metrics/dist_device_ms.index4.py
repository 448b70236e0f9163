"""dist_device_ms.index4: device time of K8 in one build of both directions
over the cards (its kernels, torch.sort passes, sets and the copies between
cards; not the segments' copies in nor the outputs' copy back over PCIe):
the time inside each build's span in which any card was busy, mean over the
traced window's builds (ms).  `trace.py` merges every card's activity into
one timeline, so this is the union over the four cards, not their sum: a
stretch in which all four run counts once.  None where the window ran no
distributed build."""
from portbench import program_dist
from portbench.metrics import mean_ms
from portbench.trace import HOST_COPIES


def read(ctx):
    t = ctx["trace"]
    if program_dist.unit_seconds(t, ()) is None or not t.busy:
        return None
    return mean_ms(t.span_busy_s(skip=HOST_COPIES))
