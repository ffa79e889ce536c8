"""The 95th percentile of the window's step times (launch to synchronise),
by nearest rank; the sample count goes to standard error."""

import math
import sys


def read(win):
    times = sorted(win["times"])
    n = len(times)
    print(f"[xcbench] step_ms_p95 over {n} steps "
          f"({n - math.ceil(0.95 * n)} beyond it)", file=sys.stderr)
    return 1e3 * times[math.ceil(0.95 * n) - 1]
