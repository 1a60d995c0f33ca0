"""Semi-Lagrangian tracer transport on the Gaussian grid.

The GFS-family dynamical cores the reference wrapped advect moisture in
grid space by finite-volume or semi-Lagrangian schemes (SURVEY.md §2.4;
BASELINE north star "finite-volume/semi-Lagrangian moisture advection").
``ops/fv_advection.py`` is the conservative flux-form member; this
module is the semi-Lagrangian member: unconditionally stable in the
zonal direction (no polar substepping — the classic reason GCMs went
SL, Staniforth & Côté 1991, MWR 119), non-conservative (pair with the
dycore's global mass fixer), and shape-preserving through monotone
bilinear interpolation.

Scheme (two-time-level, midpoint trajectories):

1. Departure points: angular displacements alpha = u dt / (a cos phi),
   beta = v dt / a, iterated ``n_iter`` times with the velocity
   re-interpolated at the trajectory midpoint (Robert 1981 fixed-point
   iteration; 2 iterations give O(dt^3) trajectories).
2. Interpolation: bilinear in (lambda, mu-index) — monotone, so no
   over/undershoots and positivity is preserved; longitude periodic,
   latitude clamped at the first/last Gaussian row (trajectories at
   GCM Courant numbers never reach the pole gap).  The non-uniform
   Gaussian latitudes are inverted through a fine uniform lookup table
   (fractional-index map), not per-point searches.
3. Vertical: the same mass-flux upwind pass as the FV operator, on the
   dycore's diagnosed interface mass flux (keeps the vertical transport
   consistent between the two schemes).

Array mapping: each bilinear corner is ONE bulk flattened gather per
field (indices precomputed elementwise); there are 4 corner gathers per
interpolation and 2 velocity interpolations per trajectory iteration.
Gathers are memory-bound, but the SL operator runs once per tracer
per step on (nz, nlat, nlon) fields — bandwidth-bound, not the step's
critical path (the FV path's polar zonal substepping costs more at
high resolution).

Reference behavior: the reference has no in-tree SL code (the dycore
was split out, HISTORY.rst:5-8); this implements the documented
capability with whole-grid array operations.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np


class SLAdvection:
    """Semi-Lagrangian transport operator for one grid/timestep.

    Interface-compatible with ``FVAdvection``: ``advect(q, dp, u, v,
    mdot, dt)`` on top-down (nz, nlat, nlon) fields, latitude row 0
    northernmost.
    """

    def __init__(self, mu, weights, nlon, radius, dt_max,
                 dtype=jnp.float32, n_iter=2, table_oversample=8):
        del dt_max                               # stability: none needed
        mu = np.asarray(mu, np.float64)
        self._w = jnp.asarray(np.asarray(weights, np.float64), dtype)
        self.nlat = mu.shape[0]
        self.nlon = nlon
        self.radius = radius
        self.dtype = dtype
        self.n_iter = n_iter
        phi = np.arcsin(mu)                      # descending (N -> S)
        self._phi = jnp.asarray(phi, dtype)
        self._coslat = jnp.asarray(np.cos(phi), dtype)
        self.dlam = 2.0 * math.pi / nlon

        # fractional-index inversion of the (non-uniform, descending)
        # Gaussian latitudes: uniform fine table over [phi_S, phi_N]
        nt = table_oversample * self.nlat
        phi_asc = phi[::-1]                      # ascending for interp
        tbl_phi = np.linspace(phi_asc[0], phi_asc[-1], nt)
        idx_asc = np.interp(tbl_phi, phi_asc, np.arange(self.nlat))
        # table entry k holds the DESCENDING row index of tbl_phi[k]
        self._lat_tbl = jnp.asarray((self.nlat - 1) - idx_asc, dtype)
        self._tbl_phi0 = float(tbl_phi[0])
        self._tbl_dphi = float(tbl_phi[1] - tbl_phi[0])
        self._tbl_n = nt

    # -- fractional grid coordinates of (lam, phi) points -----------------
    def _lat_index(self, phi):
        """Fractional descending-row index of latitude phi (clamped).

        Two stages: the uniform fine table gives an O(0.1 cell)
        estimate; one refinement against the actual Gaussian latitudes
        makes the piecewise-linear inverse exact (so departure points
        that land on grid rows interpolate with 0/1 weights)."""
        x = (phi - self._tbl_phi0) / self._tbl_dphi
        x = jnp.clip(x, 0.0, self._tbl_n - 1.0)
        i0 = jnp.clip(x.astype(jnp.int32), 0, self._tbl_n - 2)
        f = x - i0
        t = self._lat_tbl
        est = t[i0] * (1.0 - f) + t[i0 + 1] * f
        j0 = jnp.clip(est.astype(jnp.int32), 0, self.nlat - 2)
        phi0 = self._phi[j0]
        phi1 = self._phi[j0 + 1]
        frac = (phi0 - phi) / (phi0 - phi1)       # phi descending
        return jnp.clip(j0 + frac, 0.0, float(self.nlat - 1))

    def _interp(self, field, lam_idx, lat_idx):
        """Monotone bilinear interpolation of (nz, nlat, nlon) ``field``
        at fractional (lon index, lat row index) points of the same
        shape: one flattened bulk gather per corner."""
        nlat, nlon = self.nlat, self.nlon
        i0 = jnp.floor(lam_idx).astype(jnp.int32)
        fx = (lam_idx - i0).astype(field.dtype)
        i0 = jnp.mod(i0, nlon)
        i1 = jnp.mod(i0 + 1, nlon)
        j0 = jnp.clip(jnp.floor(lat_idx).astype(jnp.int32), 0, nlat - 2)
        fy = jnp.clip(lat_idx - j0, 0.0, 1.0).astype(field.dtype)
        j1 = j0 + 1

        nzdim = field.shape[0]
        flat = field.reshape(nzdim, nlat * nlon)

        def corner(j, i):
            idx = (j * nlon + i).reshape(nzdim, -1)
            return jnp.take_along_axis(flat, idx, axis=1).reshape(
                field.shape)

        q00 = corner(j0, i0)
        q01 = corner(j0, i1)
        q10 = corner(j1, i0)
        q11 = corner(j1, i1)
        top = q00 + fx * (q01 - q00)
        bot = q10 + fx * (q11 - q10)
        return top + fy * (bot - top)

    # -- departure points --------------------------------------------------
    def _departure(self, u, v, dt):
        """Fractional (lon, lat) indices of departure points via midpoint
        fixed-point iteration."""
        nz = u.shape[0]
        lam_a = jnp.arange(self.nlon, dtype=self.dtype) * self.dlam
        lam_a = jnp.broadcast_to(lam_a, u.shape)
        phi_a = jnp.broadcast_to(self._phi[None, :, None], u.shape)

        # first guess: arrival-point velocity over the full step
        u_m, v_m = u, v
        lam_d, phi_d = lam_a, phi_a
        for _ in range(self.n_iter):
            cos_m = jnp.maximum(jnp.cos(
                0.5 * (phi_a + phi_d)), 0.05)
            alpha = u_m * dt / (self.radius * cos_m)
            beta = v_m * dt / self.radius
            lam_d = lam_a - alpha
            phi_d = jnp.clip(phi_a - beta, self._phi[-1], self._phi[0])
            # midpoint velocity for the next pass
            lam_m = lam_a - 0.5 * alpha
            phi_m = jnp.clip(phi_a - 0.5 * beta,
                             self._phi[-1], self._phi[0])
            lam_im = lam_m / self.dlam
            lat_im = self._lat_index(phi_m)
            u_m = self._interp(u, lam_im, lat_im)
            v_m = self._interp(v, lam_im, lat_im)
        del nz
        return lam_d / self.dlam, self._lat_index(phi_d)

    # -- vertical (upwind on the dycore's interface mass flux) -------------
    def _vertical(self, q, dp, mdot, dt):
        q_up = jnp.where(mdot >= 0.0, q[:-1], q[1:])
        F = mdot * q_up * dt
        zero = jnp.zeros_like(q[:1])              # robust at nz == 1
        F_full = jnp.concatenate([zero, F, zero], axis=0)
        M_full = jnp.concatenate([zero, mdot * dt, zero], axis=0)
        Q = q * dp - (F_full[1:] - F_full[:-1])
        dp_new = dp - (M_full[1:] - M_full[:-1])
        return Q / dp_new

    # -- full step ---------------------------------------------------------
    def advect(self, q, dp, u, v, mdot, dt):
        """One semi-Lagrangian transport step over ``dt``.

        q, dp, u, v: (nz, nlat, nlon) top-down; mdot (nz-1, nlat, nlon)
        interface mass flux.  Returns the transported mixing ratio; the
        horizontal pass is non-conservative (advective form), so the
        dycore's global mass fixer stays ON for this scheme.
        """
        lam_idx, lat_idx = self._departure(u, v, dt)
        q_h = self._interp(q, lam_idx, lat_idx)
        return self._vertical(q_h, dp, mdot, dt)

    def total_mass(self, q, dp):
        """Area-weighted tracer mass (diagnostic; NOT conserved by
        ``advect`` — the fixer closes the budget globally)."""
        return jnp.sum(q * dp * self._w[None, :, None])
