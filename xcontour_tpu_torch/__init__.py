"""xcontour_tpu_torch: contour-coordinate diagnostics in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (H100).

The port of ``xcontour_tpu`` (JAX/Pallas), which stays beside it as the
reference.  This package imports torch and numpy only.  It covers the
combined Keff + LWA step (:func:`keff_lwa_pipeline`) and what that step
runs: grid metrics, the |grad q|^2 stencil, the weighted-CDF engine, the
A(Y_eq) table, the Keff algebra and local wave activity.

Plain PyTorch versions run on CPU tensors; CUDA tensors go through the
kernels in ``csrc/``, which ``nvcc`` builds at first use.
"""

__version__ = "0.1.0"

from . import core, grid
from .core import (Table, cal_area_eqCoord_table_hist, cal_contours,
                   cal_gradient_wrt_area, cal_integral_within_contours_hist,
                   cal_normalized_Keff, cal_sqared_equivalent_length,
                   interp_to_coords)
from .diagnostics.lwa import local_wave_activity
from .grid import (Grid, equivalent_latitudes, from_cartesian, from_latlon,
                   from_metrics, grid_from_numpy, latitude_lengths_at)
from .ops.stencil import gradient, squared_gradient
from .pipeline import keff_lwa_pipeline

__all__ = [
    "Grid", "Table", "cal_area_eqCoord_table_hist", "cal_contours",
    "cal_gradient_wrt_area", "cal_integral_within_contours_hist",
    "cal_normalized_Keff", "cal_sqared_equivalent_length", "core",
    "equivalent_latitudes", "from_cartesian", "from_latlon", "from_metrics",
    "gradient", "grid", "grid_from_numpy", "interp_to_coords",
    "keff_lwa_pipeline", "latitude_lengths_at", "local_wave_activity",
    "squared_gradient",
]
