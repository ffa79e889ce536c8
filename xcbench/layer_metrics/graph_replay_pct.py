"""The share of the host's time in the pipeline entries spent replaying a
step's CUDA graph: the union of the ``graph.replay`` ranges in the traced
window over the union of its ``pipeline.*`` ranges (the outermost entry
ranges), in percent.  0 where no step replays a graph (a program without
graphs opens no such range); None where no entry ran."""


def _union_us(spans, t0, t1) -> float:
    total, end = 0.0, t0
    for a, b in sorted(spans):
        a, b = max(a, end), min(b, t1)
        if b > a:
            total += b - a
            end = b
    return total


def read(tr):
    entries = [(a, b) for name, a, b, _ in tr.ranges
               if name.startswith("pipeline.")]
    if not entries:
        return None
    replays = [(a, b) for _, a, b, _ in tr.ranges_named({"graph.replay"})]
    return 100.0 * _union_us(replays, tr.t0, tr.t1) / \
        _union_us(entries, tr.t0, tr.t1)
