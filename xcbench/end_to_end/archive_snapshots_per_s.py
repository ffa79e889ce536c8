"""Snapshots of every pass of the window (archive open to output file
written) over the time from the window's start to the end of its last
pass."""


def read(win):
    return win["units"] / win["window_s"]
