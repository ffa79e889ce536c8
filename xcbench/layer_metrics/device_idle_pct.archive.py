"""The share of the traced window in which no kernel, copy or set runs on
the card: the window less the union of device intervals."""


def read(tr):
    if not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
