"""sa_roofline.index: K6's share of its roofline: the least time of a build
of both directions at the card's memory rate (`roofline/bytes.py`
`index_build`) over K6's device time a build (`sa_device_ms.index`), in %."""
import sys

from portbench.metrics import mean_ms
from portbench.roofline.bytes import least_ms
from portbench.trace import HOST_COPIES


def read(ctx):
    t = ctx["trace"]
    nbytes = ctx["least_bytes"].get("sa")
    if t is None or not t.busy or nbytes is None:
        return None
    least, device = least_ms(ctx["kind"], nbytes), mean_ms(t.span_busy_s(skip=HOST_COPIES))
    if least is None or not device:
        return None
    print(f"[portbench] sa_roofline.index: {nbytes} B a build, least {least} ms at the card's "
          f"memory rate, over {device} ms of K6's device time a build", file=sys.stderr)
    return 100 * least / device
