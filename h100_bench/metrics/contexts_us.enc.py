"""Device us a traced encode step of the program's `contexts` part: the
boundary contexts (core/step.py `_boundary`, the PPM update left out) and
the match pointers, mapped onto the captured graphs' layouts (parts.py).
Silent where the window does not align."""
from h100_bench import parts


def read(run):
    return parts.part_us(run, "contexts")
