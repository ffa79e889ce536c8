"""Physical constants shared across the library.

Counterpart of ``xcontour_tpu/utils/constants.py``; the values are the
reference's (xcontour utils.py:18-30).  Plain Python floats, so multiplying a
tensor by one keeps the tensor's dtype.
"""

# Radius of the Earth (m)
Rearth = 6371200.0

# Rotation angular speed of the Earth (s^-1)
omega = 7.292e-5
