"""The fused sub-step kernel's share of its roofline, in %: the least time
for the configuration's frozen bytes (S streams' and the spec's constants)
and float operations of one launch, over its traced device time a launch.
Silent where the trace holds no launch of it."""


def read(run):
    t = run.trace
    if t is None or run.peaks is None:
        return None
    launches = t.kernels(run.config["kernels"]["fused"])
    if not launches:
        return None
    c = run.config["counts_per_stream"]["fused"]
    least = max((c["bytes"] * run.S + c["bytes_const"]) / run.peaks["bytes_per_s"],
                c["float_ops"] * run.S / run.peaks["f32_ops_per_s"])
    per_launch = sum(e - s for _, s, e in launches) / 1e9 / len(launches)
    return 100.0 * least / per_launch
