"""The share of the ``cli.stream`` ranges in which their thread is inside
neither ``runner.step`` nor ``runner.fetch``: the main thread waiting on
the runner's read and copy threads (which the profiler does not see)."""


def read(tr):
    streams = tr.ranges_named({"cli.stream"})
    if not streams:
        return None
    inner = tr.ranges_named({"runner.step", "runner.fetch"})
    total = waited = 0.0
    for _, a, b, tid in streams:
        spans = sorted((max(a, x), min(b, y)) for _, x, y, t in inner
                       if t == tid and x < b and y > a)
        covered, end = 0.0, a
        for x, y in spans:
            if y > end:
                covered += y - max(x, end)
                end = y
        total += b - a
        waited += (b - a) - covered
    return 100.0 * waited / total
