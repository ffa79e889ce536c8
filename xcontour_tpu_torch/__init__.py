"""xcontour_tpu_torch: contour-coordinate diagnostics in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (H100).

The port of ``xcontour_tpu`` (JAX/Pallas), which stays beside it as the
reference.  This package imports torch and numpy only.  It covers the
three Keff/LWA pipelines (:func:`keff_pipeline`, :func:`lwa_pipeline` and
the combined :func:`keff_lwa_pipeline`), the two geometry pipelines
(:func:`clength_pipeline`, :func:`fractal_pipeline`) and windowed local
lengths (:func:`local_length_pipeline`, :func:`local_contour_lengths`), and
what they run: grid metrics
(latitude-longitude, Cartesian and the MITgcm x-z plane), the |grad q|^2
stencil, the weighted-CDF engine, the broadcast and exact sort-based
conditional integrals, the A(Y_eq) tables, the Keff algebra and the contour
means, the contour levels at prescribed coordinates, local wave activity in
both the LWA and the impulse-Casimir LWA2 form (with the sort-merge 'fast'
method for tall grids), marching-squares perimeters, box counting,
coarsening and the fractal dimension.

The reference's facade comes with it: :class:`Contour2D` in both
constructor generations, the ``xcontour`` namespace with its metric
constructors (:func:`add_latlon_metrics` and the others), :func:`lwa_masks_at`,
labelled datasets (:func:`pipeline.as_dataset`, ``utils.ncio``), the host
contour tools (``host``: marching-squares extraction and the wave-breaking
chain), the float64 oracle ``compat`` and, imported on its own, ``viz``.

Plain PyTorch versions run on CPU tensors; CUDA tensors go through the
kernels in ``csrc/``, which ``nvcc`` builds at first use.  The sharded
steps over several ranks (one card a rank, torch.distributed) are in
``parallel``, imported on its own.
"""

__version__ = "0.1.0"

from . import compat, core, grid
from .core import (Contour2D, Table, cal_area_eqCoord_table,
                   cal_area_eqCoord_table_hist, cal_contour_mean,
                   cal_contour_mean_hist, cal_contour_weigh_mean,
                   cal_contour_weigh_mean_hist, cal_contours,
                   cal_contours_at, cal_gradient_wrt_area,
                   cal_integral_within_contours,
                   cal_integral_within_contours_exact,
                   cal_integral_within_contours_hist, cal_normalized_Keff,
                   cal_sqared_equivalent_length, get_extrema_extend,
                   interp_to_coords)
from .diagnostics.fractal import fractal_dimension, loglog_slope
from .diagnostics.length import contour_crossing, contour_lengths
from .diagnostics.local_length import local_contour_lengths, rolling_mean
from .diagnostics.lwa import (local_wave_activity, local_wave_activity2,
                              lwa_masks_at)
from .grid import (Grid, equivalent_latitudes, from_cartesian, from_latlon,
                   from_metrics, from_xz, grid_from_numpy, latitude_lengths_at,
                   to_host)
from .ops.stencil import gradient, squared_gradient
from .pipeline import (as_dataset, clength_pipeline, flatten_output,
                       fractal_pipeline, keff_lwa_pipeline, keff_pipeline,
                       local_length_pipeline, lwa_pipeline)
from .utils.coarsen import coarsen
from .utils.constants import Rearth, deg2m, g, omega
# the reference's top-level metric constructors; the whole reference namespace
# is the module xcontour
from .xcontour import (add_latlon_metrics, add_latlon_metrics_old,
                       add_MITgcm_missing_metrics, contour_area,
                       contour_length)

__all__ = [
    "Contour2D", "Grid", "Rearth", "Table", "add_MITgcm_missing_metrics",
    "add_latlon_metrics", "add_latlon_metrics_old", "as_dataset",
    "cal_area_eqCoord_table", "cal_area_eqCoord_table_hist",
    "cal_contour_mean", "cal_contour_mean_hist", "cal_contour_weigh_mean",
    "cal_contour_weigh_mean_hist", "cal_contours", "cal_contours_at",
    "cal_gradient_wrt_area", "cal_integral_within_contours",
    "cal_integral_within_contours_exact", "cal_integral_within_contours_hist",
    "cal_normalized_Keff", "cal_sqared_equivalent_length", "clength_pipeline",
    "coarsen", "compat", "contour_area", "contour_crossing",
    "contour_length", "contour_lengths", "core", "deg2m",
    "equivalent_latitudes", "flatten_output", "fractal_dimension",
    "fractal_pipeline", "from_cartesian", "from_latlon", "from_metrics",
    "from_xz", "g", "get_extrema_extend", "gradient", "grid", "grid_from_numpy",
    "interp_to_coords", "keff_lwa_pipeline", "keff_pipeline",
    "latitude_lengths_at", "local_contour_lengths", "local_length_pipeline",
    "local_wave_activity", "local_wave_activity2", "loglog_slope",
    "lwa_masks_at", "lwa_pipeline",
    "omega", "rolling_mean", "squared_gradient", "to_host",
]
