"""stage_ms.index4: the host's staging of a distributed build: the time of
the program's `siga.dist.pin` spans (each segment written into pinned
memory and its copy to its card enqueued) and `siga.dist.fetch` spans (the
outputs compacted and copied back from every card into one pinned buffer
each) less the `siga.dist.wait` spans inside them (the host blocked on a
card), both directions summed, mean over the traced window's builds (ms).
The four cards' copies share the one host process and its spans."""
from portbench import program_dist
from portbench.metrics import mean_ms


def read(ctx):
    t = ctx["trace"]
    staged = program_dist.unit_seconds(t, ("siga.dist.pin", "siga.dist.fetch"))
    if staged is None:
        return None
    waits = program_dist.unit_seconds(t, ("siga.dist.wait",))
    return mean_ms([s - w for s, w in zip(staged, waits)])
