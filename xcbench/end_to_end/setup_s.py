"""Seconds from the process's start to the first timed step: imports, the
CUDA context, the kernel library (built on a checkout's first run),
inputs, tables and warm-up."""


def read(win):
    return win["setup_s"]
