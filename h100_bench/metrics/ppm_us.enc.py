"""Device us a traced encode step of the program's `ppm` part (core/ppm.py:
the count update, the row indices and the prediction), mapped onto the
captured graphs' layouts (parts.py). Silent where the window does not
align."""
from h100_bench import parts


def read(run):
    return parts.part_us(run, "ppm")
