"""exchange_ms.index4: the host's part of K8's global sorts: the time of
the program's `siga.dist.exchange` spans (the splitters, each segment's
bucket bounds, the host's wait for the D x D piece sizes, the pieces'
copies between cards enqueued), both directions summed, mean over the
traced window's builds (ms).  One host process drives the four cards, so
the spans lie on one timeline."""
from portbench import program_dist
from portbench.metrics import mean_ms


def read(ctx):
    return mean_ms(program_dist.unit_seconds(ctx["trace"], ("siga.dist.exchange",)))
