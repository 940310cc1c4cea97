"""The row movers' share of their roofline, in %: the configuration's frozen
bytes of every gather and scatter of an encode step (S streams') over the
memory rate, against the movers' traced device time a step. Silent where
the trace holds no mover."""


def read(run):
    t = run.trace
    if t is None or run.peaks is None:
        return None
    launches = t.kernels(run.config["kernels"]["movers"])
    if not launches:
        return None
    least = run.config["counts_per_stream"]["movers"]["bytes"] * run.S / run.peaks["bytes_per_s"]
    per_step = sum(e - s for _, s, e in launches) / 1e9 / t.steps
    return 100.0 * least / per_step
