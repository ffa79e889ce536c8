"""Host ms a snapshot in the command-line tool's own stages: the
``cli.open``, ``cli.label`` and ``cli.write`` ranges of the traced passes
over their snapshots."""


def read(tr):
    rs = tr.ranges_named({"cli.open", "cli.label", "cli.write"})
    if not rs:
        return None
    return sum(b - a for _, a, b, _ in rs) / 1e3 / tr.units
