"""Host ms a snapshot in the runner's copy of its chunks into pinned
memory (``runner.pin`` on the read thread: the pinned block and the copy
or wire cast into it), from the program's span log placed on the traced
window."""

from xcbench import program_spans


def read(tr):
    spans = program_spans.on_trace(tr, {"runner.pin"})
    if not spans:
        return None
    return sum(b - a for _, a, b, _ in spans) / 1e3 / tr.units
