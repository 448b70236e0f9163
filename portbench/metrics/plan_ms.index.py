"""plan_ms.index: the host's plan of a build (`sort_plan`: the doubling
rounds and the tied count, from a scan of the text for its sentinels): the
time of the program's `siga.sa.sort_plan` spans, both directions summed,
mean over the traced window's builds (ms)."""
from portbench import program
from portbench.metrics import mean_ms


def read(ctx):
    return mean_ms(program.unit_seconds(ctx["trace"], ("siga.sa.sort_plan",)))
