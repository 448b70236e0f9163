"""stage_ms.index: the host's staging of a build through pinned memory: the
time of the program's `siga.sa.pin_text` spans (the text pinned and its copy
in enqueued) and `siga.sa.to_host` spans (pinned buffers for the outputs,
their copies back enqueued) less the `siga.sa.wait` spans inside them, both
directions summed, mean over the traced window's builds (ms)."""
from portbench import program
from portbench.metrics import mean_ms


def read(ctx):
    t = ctx["trace"]
    staged = program.unit_seconds(t, ("siga.sa.pin_text", "siga.sa.to_host"))
    if staged is None:
        return None
    waits = program.unit_seconds(t, ("siga.sa.wait",))
    return mean_ms([s - w for s, w in zip(staged, waits)])
