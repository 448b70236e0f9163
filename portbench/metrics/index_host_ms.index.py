"""index_host_ms.index: the host's part of a build (the plan, staging and
copy back of `index/sa.py`): the time of a build's span in which the device
ran nothing, neither K6 nor a copy, mean over the traced window's builds
(ms)."""
from portbench.metrics import mean_ms


def read(ctx):
    t = ctx["trace"]
    return None if t is None else mean_ms(t.span_host_s())
