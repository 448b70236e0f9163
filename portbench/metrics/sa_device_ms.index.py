"""sa_device_ms.index: device time of K6 in one build of both directions
(its kernels, torch.sort passes, sets and copies on the card; not the
text's copy in nor the outputs' copy back over PCIe): the device's busy
time inside each build's span without those copies, mean over the traced
window's builds (ms)."""
from portbench.metrics import mean_ms
from portbench.trace import HOST_COPIES


def read(ctx):
    t = ctx["trace"]
    return None if t is None or not t.busy else mean_ms(t.span_busy_s(skip=HOST_COPIES))
