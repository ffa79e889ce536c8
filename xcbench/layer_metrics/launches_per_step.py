"""Device kernel launches in the traced window over its steps (an exact
count from the trace)."""


def read(tr):
    return tr.kernel_count() / tr.steps if tr.kernel_count() else None
