"""wait_ms.index: the host blocked on the card for a build's outputs (the
rounds, `bwt_perm` and the copies back still running): the time of the
program's `siga.sa.wait` spans, both directions summed, mean over the traced
window's builds (ms); 0 where the build ran on the CPU, which does not
wait."""
from portbench import program
from portbench.metrics import mean_ms


def read(ctx):
    return mean_ms(program.unit_seconds(ctx["trace"], ("siga.sa.wait",)))
