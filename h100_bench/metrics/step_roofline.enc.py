"""The encode step's share of its roofline, in %: the least time the card
could take for the configuration's frozen bytes and float operations a step
(the larger of bytes over the memory rate and operations over the float32
rate) over the window's encode wall a byte step."""


def read(run):
    if run.peaks is None or not run.jobs:
        return None
    c = run.config["counts_per_stream"]["step"]
    least = max(c["bytes"] * run.S / run.peaks["bytes_per_s"], c["float_ops"] * run.S / run.peaks["f32_ops_per_s"])
    return 100.0 * least / run.encode_step_s()
