"""The readers of the benchmark's metrics: `metrics/<name>.py` for each
metric of BENCHMARK.json, found by the metric's name.  A reader's
`read(ctx)` returns the metric's value, or None where it finds nothing to
read; the harness then leaves the metric out.  `ctx` (built by
`harness.run`): units, window_s, setup_s, work, least_bytes, kind (the
card's name), trace (a `trace.Trace`, or None without --trace 1), counters
(the entry's own), peak_window_bytes."""


def mean_ms(seconds) -> float | None:
    """The mean of a list of seconds, in ms; None for an empty list."""
    return 1e3 * sum(seconds) / len(seconds) if seconds else None
