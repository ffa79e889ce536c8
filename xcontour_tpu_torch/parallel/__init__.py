"""Sharded execution over a torch.distributed ('batch', 'x') mesh.

Counterpart of ``xcontour_tpu.parallel``: the mesh helpers, the sharded
CDF, exact sort, LWA, halo stencil, halo and windowed lengths, and the
sharded pipeline steps (:mod:`.pipeline`), each taking and returning a
rank's local block.  The collectives live in :mod:`._comm`; ranks are
launched by torchrun, or for tests and dry runs by :mod:`.launch`.

Gradients.  Every sharded function and step is differentiable, as
``jax.grad`` goes through ``shard_map``: the collectives' backwards are
collectives (:mod:`._comm`).  In JAX the loss is a function of the
global arrays, so an output replicated over 'x' counts once; here each
rank computes a loss on its own blocks, and :func:`once_per_mesh`
weights a replicated output by 1 / size('x') so that the ranks' losses
add up to JAX's.  An x-sharded output (``lwa``, ``lwa2``, the stencil's
and the gradient's blocks) is summed over the rank's block as it is.
The JAX suite's sharded adjoint (tests/test_parallel.py),
``nansum(lwa**2) + nansum(nkeff)`` of ``keff_lwa_pipeline``, is on
every rank::

    out = sharded_keff_lwa_pipeline(t, grid, mesh, N=11, lmin="analytic")
    loss = (torch.nansum(out["lwa"] ** 2)
            + torch.nansum(once_per_mesh(out["nkeff"], mesh)))
    loss.backward()        # t.grad: the rank's block of jax.grad's

Every rank must take the same gradient (the backward runs collectives).
A replicated input's gradient on a rank (LWA's ``Q``, the lengths'
levels) is the rank's share; the shares add up over 'x' to JAX's.
``runner.run_batched(sharding=)`` and the CLI's ``--mesh`` run forward
only, as the JAX runner does.
"""

from .mesh import (make_mesh, make_hybrid_mesh, once_per_mesh,  # noqa: F401
                   shard_batch_spec)
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
