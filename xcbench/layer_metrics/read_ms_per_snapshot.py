"""Host ms a snapshot in the runner's read of its chunks (``runner.read``
on the read thread: the archive's page-in, byte swap, flip, cast and
mask), from the program's span log placed on the traced window."""

from xcbench import program_spans


def read(tr):
    spans = program_spans.on_trace(tr, {"runner.read"})
    if not spans:
        return None
    return sum(b - a for _, a, b, _ in spans) / 1e3 / tr.units
