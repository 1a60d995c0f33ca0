"""Table-row interpolation primitives for the RRTMG gas-optics kernels.

The correlated-k scheme is dominated by weighted sums of rows of small
k-coefficient tables:

    out[z, c, :] = sum_t  w_t[z, c] * table[idx_t[z, c], :]

(the 2x2x2 pressure/temperature/eta interpolation of
rrtmg_lw_taumol.f90 / rrtmg_sw_taumol.f90, the water-vapor continuum
terms, the minor-absorber terms, and the Planck-fraction eta
interpolation all have this shape).

For float32/bfloat16 inputs ``mix_rows`` builds the combined sparse
weight matrix W[z, c, r] = sum_t w_t * onehot(idx_t) and contracts it
against the table in one dot, at the 'table' precision of
ops/precision.py.  float64 inputs (the golden-parity validation mode)
keep exact sequential row gathers.  Whether row gathers or the one-hot
dot are faster on the GPU has not been measured.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ...ops.precision import dot_precision


def mix_rows(table, terms):
    """sum_t w_t * table[clip(idx_t)] over (idx, weight) pairs.

    Args:
      table: (rows, ng) coefficient table.
      terms: iterable of (idx, w): idx int32 arrays of shape S, w arrays
        of shape S (already including any regime masks / column factors).
    Returns:
      (S..., ng) array in the weights' dtype.
    """
    terms = list(terms)
    rows = table.shape[0]
    w0 = terms[0][1]
    if w0.dtype == jnp.float64:
        acc = None
        for idx, w in terms:
            t = w[..., None] * table[jnp.clip(idx, 0, rows - 1)]
            acc = t if acc is None else acc + t
        return acc
    iota = jnp.arange(rows, dtype=jnp.int32)
    W = None
    for idx, w in terms:
        oh = (jnp.clip(idx, 0, rows - 1)[..., None] == iota)
        t = w[..., None] * oh
        W = t if W is None else W + t
    nd = W.ndim
    # precision: ops/precision.py 'table'.  The f32 fast path's accuracy
    # budget is the fastpath-vs-f64 bound (tests/test_radiation_fastpath.py:
    # fluxes atol 0.5 W/m2, heating atol 0.05 K/day); f64 golden parity
    # keeps exact gathers above.
    return jax.lax.dot_general(
        W, table.astype(W.dtype), (((nd - 1,), (0,)), ((), ())),
        precision=dot_precision('table'))


def mix_rows_windowed(table, terms, window):
    """``mix_rows`` restricted to a per-level row window (f32 path).

    The key-species tables are laid out as jp-major blocks
    (jp, jt, eta); at any fixed model level the pressure index jp spans
    at most ~2 of the 13 (lower) / 47 (upper) jp values, so every
    nonzero-weight row index at that level falls inside a ``window``-row
    span.  Contracting a per-level dynamic table slice instead of the
    full table cuts the one-hot matmul's flops AND the materialized
    sparse-weight traffic by rows/window (3-12x) at identical numerics
    (the same rows are selected with the same weights; zero-weight
    clipped indices contribute exactly 0 either way).

    Args:
      table: (rows, ng).
      terms: [(idx, w)] with idx/w of shape (nz, ncol); weights already
        include regime masks, so out-of-regime indices carry w == 0.
      window: static row-window size; must cover the worst per-level
        spread of nonzero-weight indices (callers size it as 4 jp-blocks
        — the physical spread is <= 2 blocks plus the jp+1 side).
    Returns:
      (nz, ncol, ng) in the weights' dtype.
    """
    terms = list(terms)
    rows, ng = table.shape
    if rows <= window:
        return mix_rows(table, terms)
    big = jnp.int32(rows)
    lo = None
    for idx, w in terms:
        cand = jnp.where(w != 0.0, idx, big)
        m = jnp.min(cand, axis=1)                # (nz,)
        lo = m if lo is None else jnp.minimum(lo, m)
    base = jnp.clip(lo, 0, rows - window)        # (nz,)
    iota = jnp.arange(window, dtype=jnp.int32)
    W = None
    for idx, w in terms:
        rel = idx - base[:, None]
        # out-of-window safety: drop (exact 0), never select a wrong row
        w = jnp.where((rel >= 0) & (rel < window), w, 0.0)
        rel = jnp.clip(rel, 0, window - 1)
        t = w[..., None] * (rel[..., None] == iota)
        W = t if W is None else W + t
    tbl_z = jax.vmap(
        lambda b: jax.lax.dynamic_slice_in_dim(table, b, window, axis=0))(
            base)                                # (nz, window, ng)
    return jax.lax.dot_general(
        W, tbl_z.astype(W.dtype), (((2,), (1,)), ((0,), (0,))),
        precision=dot_precision('table'))


def lin_rows(table, idx, frac, weight=None):
    """weight * (table[idx] + frac * (table[idx+1] - table[idx])).

    The standard two-point table interpolation re-expressed for
    ``mix_rows``: weight*(1-frac) on row idx, weight*frac on row idx+1.
    float64 keeps the reference's exact formula and operation order.
    """
    rows = table.shape[0]
    if frac.dtype == jnp.float64:
        lo = table[jnp.clip(idx, 0, rows - 1)]
        hi = table[jnp.clip(idx + 1, 0, rows - 1)]
        out = lo + frac[..., None] * (hi - lo)
        return out if weight is None else weight[..., None] * out
    w_hi = frac if weight is None else weight * frac
    w_lo = (1.0 - frac) if weight is None else weight * (1.0 - frac)
    return mix_rows(table, [(idx, w_lo), (idx + 1, w_hi)])
