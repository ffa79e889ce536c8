"""Device ms a step of every kernel not listed in ``kernels/*.json``: the
plain-torch glue of core, ops and diagnostics."""


def read(tr):
    if not tr.kernel_count():
        return None
    hand = {n for spec in tr.kernels.values() for n in spec["names"]}
    return tr.kernel_ms(exclude=hand) / tr.steps
