"""idle_pct.index: the device's idle share of the traced window (the first
unit's start to the last unit's end): the part of it in which no kernel,
copy or set ran on the card, in %."""


def read(ctx):
    t = ctx["trace"]
    if t is None or not t.busy or t.window_s <= 0:
        return None
    return 100 * (1 - t.busy_s / t.window_s)
