"""dist_roofline.index4: K8's share of its roofline: the least time of a
build of both directions at one card's memory rate (`roofline/bytes.py`
`index_build`) over K8's device time a build (`dist_device_ms.index4`, the
union over the cards), in %.  Four cards could move those bytes in a
quarter of the least time; the share counts one card's rate, as the
one-card cells' does."""
import sys

from portbench import program_dist
from portbench.metrics import mean_ms
from portbench.roofline.bytes import least_ms
from portbench.trace import HOST_COPIES


def read(ctx):
    t = ctx["trace"]
    nbytes = ctx["least_bytes"].get("dist")
    if program_dist.unit_seconds(t, ()) is None or not t.busy or nbytes is None:
        return None
    least, device = least_ms(ctx["kind"], nbytes), mean_ms(t.span_busy_s(skip=HOST_COPIES))
    if least is None or not device:
        return None
    print(f"[portbench] dist_roofline.index4: {nbytes} B a build, least {least} ms at one card's "
          f"memory rate, over {device} ms of K8's device time a build", file=sys.stderr)
    return 100 * least / device
