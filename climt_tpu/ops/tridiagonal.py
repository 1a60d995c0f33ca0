"""Batched tridiagonal (Thomas) solver.

The reference's IceSheet builds a scipy sparse matrix and calls spsolve per
column (/root/reference/climt/_components/surface_ice.py:346-395); in JAX the
idiomatic form is the Thomas algorithm as two ``lax.scan`` sweeps with the
batch (column) axis vectorized.  O(n) work, no data-dependent
shapes, differentiable.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def tridiagonal_solve(lower, diag, upper, rhs):
    """Solve (lower, diag, upper) x = rhs along the LEADING axis.

    Args:
        lower: (n, ...) subdiagonal; lower[0] ignored.
        diag: (n, ...) main diagonal.
        upper: (n, ...) superdiagonal; upper[-1] ignored.
        rhs: (n, ...) right-hand side.

    Returns:
        x: (n, ...) solution, batched over trailing axes.
    """

    def forward(carry, inputs):
        c_prev, d_prev = carry
        a, b, c, d = inputs
        denom = b - a * c_prev
        c_new = c / denom
        d_new = (d - a * d_prev) / denom
        return (c_new, d_new), (c_new, d_new)

    zeros = jnp.zeros_like(diag[0])
    _, (c_prime, d_prime) = jax.lax.scan(
        forward, (zeros, zeros), (lower, diag, upper, rhs))

    def backward(x_next, inputs):
        c, d = inputs
        x = d - c * x_next
        return x, x

    _, x = jax.lax.scan(backward, zeros, (c_prime, d_prime), reverse=True)
    return x
