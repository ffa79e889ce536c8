"""Physical constants shared across the library.

Counterpart of ``xcontour_tpu/utils/constants.py``; the values are the
reference's (xcontour utils.py:18-30).  Plain Python floats, so multiplying a
tensor by one keeps the tensor's dtype.
"""

import math

# Radius of the Earth (m)
Rearth = 6371200.0

# Gravitational acceleration (m s^-2)
g = 9.80665

# Rotation angular speed of the Earth (s^-1)
omega = 7.292e-5


def deg2m(Rearth: float = Rearth) -> float:
    """Distance of one degree of arc at the equator (m)."""
    return 2.0 * math.pi * Rearth / 360.0
