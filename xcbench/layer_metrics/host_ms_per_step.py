"""Host ms a step inside the pipeline entries: the union of the
``pipeline.*`` ranges in the traced window over its steps, the host's time
launching a step without the driver's ring pick and closing synchronise."""


def read(tr):
    spans = sorted((a, b) for name, a, b, _ in tr.ranges
                   if name.startswith("pipeline."))
    if not spans:
        return None
    total, end = 0.0, tr.t0
    for a, b in spans:
        a, b = max(a, end), min(b, tr.t1)
        if b > a:
            total += b - a
            end = b
    return total / 1e3 / tr.steps
