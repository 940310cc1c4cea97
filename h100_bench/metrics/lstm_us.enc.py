"""Device us a traced encode step of the program's `lstm` part (core/lstm.py:
the forward pass, the byte end's perceive, and the whole graph of the
deferred backward pass, spread over the steps of its window), mapped onto
the captured graphs' layouts (parts.py). Silent where the window does not
align."""
from h100_bench import parts


def read(run):
    return parts.part_us(run, "lstm")
