"""The mean of the benchmark's synchronised spans around each reset of the
predictor to the fresh state (two a job: before the encode and before the
decode), in ms."""


def read(run):
    spans = [s for j in run.jobs for s in j.reset_s]
    return 1e3 * sum(spans) / len(spans) if spans else None
