"""fits_ms.index: the free-memory check of a build (`_check_fits`: the
card's free memory and the caching allocator's reserve, read before the
sort): the time of the program's `siga.sa.check_fits` spans, both directions
summed, mean over the traced window's builds (ms)."""
from portbench import program
from portbench.metrics import mean_ms


def read(ctx):
    return mean_ms(program.unit_seconds(ctx["trace"], ("siga.sa.check_fits",)))
