"""Snapshots of every step of the window over the window's wall time
(from its start to the end of its last step)."""


def read(win):
    return win["units"] / win["window_s"]
