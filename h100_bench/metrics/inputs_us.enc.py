"""Device us a traced encode step of the program's `inputs` part: the row
indices, the grouped gather (ops/rowmove.py), the coder byte window and
`pack_inputs` (core/fused.py), mapped onto the captured graphs' layouts
(parts.py). Silent where the window does not align."""
from h100_bench import parts


def read(run):
    return parts.part_us(run, "inputs")
