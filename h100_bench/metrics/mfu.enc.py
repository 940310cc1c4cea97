"""The encode step's share of the card's float32 peak outside the tensor
cores, in %: the configuration's frozen float operations a step (S times a
stream's) over the window's encode wall a byte step times the peak."""


def read(run):
    if run.peaks is None or not run.jobs:
        return None
    ops = run.config["counts_per_stream"]["step"]["float_ops"] * run.S
    return 100.0 * ops / (run.encode_step_s() * run.peaks["f32_ops_per_s"])
