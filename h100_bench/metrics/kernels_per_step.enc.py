"""CUDA kernels the profiler sees a traced encode byte step (the backward
pass's kernels spread over the steps of its window)."""


def read(run):
    t = run.trace
    if t is None:
        return None
    n = len(t.kernels())
    return n / t.steps if n else None
