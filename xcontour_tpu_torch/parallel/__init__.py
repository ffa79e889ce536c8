"""Sharded execution over a torch.distributed ('batch', 'x') mesh.

Counterpart of ``xcontour_tpu.parallel``: the mesh helpers, the sharded
CDF, exact sort, LWA, halo stencil, halo and windowed lengths, and the
sharded pipeline steps (:mod:`.pipeline`), each taking and returning a
rank's local block.  The collectives live in :mod:`._comm`; ranks are
launched by torchrun, or for tests and dry runs by :mod:`.launch`.
"""

from .mesh import make_mesh, make_hybrid_mesh, shard_batch_spec  # noqa: F401
from .histogram import (sharded_weighted_cdf,  # noqa: F401
                        sharded_weighted_cdf_multi)
from .sort import sharded_exact_conditional_integral  # noqa: F401
from .lwa import (sharded_local_wave_activity,  # noqa: F401
                  sharded_local_wave_activity2)
from .length import sharded_contour_lengths  # noqa: F401
from .local_length import sharded_local_lengths  # noqa: F401
from .stencil import sharded_gradient, sharded_squared_gradient  # noqa: F401
from .pipeline import (X_SHARDED, replicated_table,  # noqa: F401
                       sharded_clength_pipeline, sharded_contours,
                       sharded_keff_lwa_pipeline, sharded_keff_pipeline,
                       sharded_lwa_pipeline)
