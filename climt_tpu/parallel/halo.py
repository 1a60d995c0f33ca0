"""One-row latitude halo exchange with ``lax.ppermute``.

The FV transport's meridional pass (ops/fv_advection.py) needs each
latitude row's immediate north/south neighbor.  On a lat-sharded mesh
that neighbor can live on the adjacent device: this module exchanges
exactly the boundary row with a collective-permute — the
grid-stencil communication pattern SURVEY.md §2.5 prescribes — and
zero-fills the global boundary rows (the poles are closed faces, so the
zero IS the physical boundary condition, matching the single-device
zero padding).

``make_lat_halo(mesh)`` returns a function with the
``FVAdvection(halo_exchange=...)`` contract: ``halo(x, +1)`` gives row
j the value of row j-1 (northern neighbor), ``halo(x, -1)`` the
southern one, for lat-sharded (nz, nlat, nlon) arrays.
Equivalence with the single-device shifts is asserted in
tests/test_fv_advection.py on the forced 8-device CPU mesh.
"""

from __future__ import annotations

import jax
from jax import lax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P


def make_lat_halo(mesh, axis='lat'):
    """Return halo(x, shift) for lat-sharded (nz, nlat, nlon) arrays."""
    L = mesh.shape[axis]
    spec = P(None, axis, None)

    def _north_body(x):
        # row j <- row j-1; device i receives device i-1's last row.
        # ppermute zero-fills non-receiving devices: device 0's first
        # row becomes zero = the closed north-pole face.
        last = x[:, -1:, :]
        recv = lax.ppermute(last, axis,
                            [(i, i + 1) for i in range(L - 1)])
        return jnp.concatenate([recv, x[:, :-1]], axis=1)

    def _south_body(x):
        first = x[:, :1, :]
        recv = lax.ppermute(first, axis,
                            [(i + 1, i) for i in range(L - 1)])
        return jnp.concatenate([x[:, 1:], recv], axis=1)

    north = jax.shard_map(_north_body, mesh=mesh, in_specs=(spec,),
                          out_specs=spec, check_vma=False)
    south = jax.shard_map(_south_body, mesh=mesh, in_specs=(spec,),
                          out_specs=spec, check_vma=False)

    def halo(x, shift):
        return north(x) if shift == +1 else south(x)

    return halo
