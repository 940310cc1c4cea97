"""Device us a traced encode step of the program's `byte_end` part
(core/step.py `_byte_finish` without the LSTM's perceive: the registers
back, the grouped scatter, history and match writes, the copy-back of the
leaves, the chunk's per-byte outputs), mapped onto the captured graphs'
layouts (parts.py). Silent where the window does not align."""
from h100_bench import parts


def read(run):
    return parts.part_us(run, "byte_end")
