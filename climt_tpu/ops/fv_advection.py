"""Flux-form finite-volume tracer transport on the Gaussian grid.

The reference's GFS dynamical core advects moisture/tracers in grid
space (finite-volume/semi-Lagrangian; SURVEY.md §2.4, §3.4) while the
dynamics stay spectral.  This module is the vectorized equivalent: a
conservative flux-form van Leer (MUSCL, monotonized-central limiter)
scheme in the (lambda, mu) coordinates of the Gaussian grid plus upwind
vertical transport on the dycore's diagnosed interface mass flux,
following the Lin & Rood (1996, MWR 124) consistency construction:

  (q dp)^+ = (q dp)^- - dt [div_h(V dp q_face) + delta_k(mdot q_face)]
     dp*^+ =      dp^- - dt [div_h(V dp)       + delta_k(mdot)      ]
       q^+ = (q dp)^+ / dp*^+

so a spatially constant mixing ratio is preserved EXACTLY regardless of
the discrete wind divergence, and total tracer mass
sum_jk (q dp)_jk w_j dlambda is conserved to roundoff (every face flux
telescopes; polar and boundary faces carry zero flux) — no global fixer
needed, unlike the spectral advective path.

Grid conventions (the dycore's internal layout): fields are top-down
(nz, nlat, nlon) with latitude index 0 = northernmost (mu descending);
the Gaussian quadrature weight w_j IS the cell's exact Delta-mu.
Longitude is periodic; latitude faces at the poles are closed.

Stability: the meridional/vertical Courant numbers are uniformly small
on the Gaussian grid (w_j ~ (pi/nlat) cos(phi_j), so
|v| dt nlat/(pi a) ~ 0.25 at GCM settings), but the zonal Courant
diverges at polar rows (dx = a cos(phi) dlambda -> 18x smaller at the
first Gaussian latitude of a T85 grid).  The zonal pass therefore
substeps per latitude BAND, with static (compile-time) substep counts
from an assumed wind bound — polar bands take more, the tropics take
one — instead of a polar filter.

Under latitude sharding the meridional one-row halo is exchanged with
``lax.ppermute`` (parallel/halo.py); single-device callers get plain
shifts.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax


def _mc_slope(qm, q0, qp):
    """Monotonized-central limited slope from (left, center, right)."""
    dc = 0.5 * (qp - qm)
    d1 = 2.0 * (q0 - qm)
    d2 = 2.0 * (qp - q0)
    s = jnp.sign(dc)
    mag = jnp.minimum(jnp.abs(dc), jnp.minimum(jnp.abs(d1), jnp.abs(d2)))
    return jnp.where(d1 * d2 > 0.0, s * mag, 0.0)


def _vanleer_face(q_up, slope_up, c_abs):
    """Upwind van Leer face value: q_up + 0.5 slope (1 - |c|)."""
    return q_up + 0.5 * slope_up * (1.0 - c_abs)


class FVAdvection:
    """Conservative flux-form transport operator for one grid/timestep."""

    def __init__(self, mu, weights, nlon, radius, dt_max,
                 dtype=jnp.float32, max_wind=120.0, halo_exchange=None):
        """``dt_max`` is the LONGEST transport interval this operator
        will be called with (2*dt_model under leapfrog; the static zonal
        substep counts are sized for it and remain CFL-safe for shorter
        calls).  ``max_wind`` bounds the zonal wind for those counts
        (CFL safety, not an accuracy knob).  ``halo_exchange``: optional
        fn(field, shift) returning the neighbor row for lat-sharded
        execution (parallel/halo.py); None uses in-array shifts
        (single-device / GSPMD-auto)."""
        mu = np.asarray(mu, np.float64)
        w = np.asarray(weights, np.float64)
        self.nlat = mu.shape[0]
        self.nlon = nlon
        self.radius = radius
        self.dt_max = float(dt_max)
        self.dtype = dtype
        coslat = np.sqrt(1.0 - mu ** 2)
        dlam = 2.0 * math.pi / nlon
        dx = radius * coslat * dlam                       # (nlat,)
        # static per-row zonal substep counts, rounded to powers of two
        # and grouped into contiguous symmetric bands
        n_sub = np.maximum(
            1, np.ceil(max_wind * self.dt_max / dx)).astype(int)
        n_sub = 2 ** np.ceil(np.log2(n_sub)).astype(int)
        bands = []                                        # (j0, j1, n)
        j0 = 0
        for j in range(1, self.nlat + 1):
            if j == self.nlat or n_sub[j] != n_sub[j0]:
                bands.append((j0, j, int(n_sub[j0])))
                j0 = j
        self.zonal_bands = bands
        self._dx = jnp.asarray(dx, dtype)                 # (nlat,)
        self._w = jnp.asarray(w, dtype)                   # Delta-mu_j
        self._coslat = jnp.asarray(coslat, dtype)
        # face Delta-mu for the meridional reconstruction Courant
        wf = 0.5 * (w[1:] + w[:-1])
        self._wface = jnp.asarray(wf, dtype)
        self.halo_exchange = halo_exchange

    # -- zonal (periodic, substepped) -------------------------------------
    def _zonal_band(self, q, dp, u, dxj, n, dt):
        """n substeps of 1-D zonal van Leer on a latitude band.

        q, dp, u: (nz, rows, nlon); dxj: (rows,).  Returns (q, dp)."""
        dt_s = dt / n
        u_face = 0.5 * (u + jnp.roll(u, -1, axis=-1))     # face i+1/2
        dp_face = 0.5 * (dp + jnp.roll(dp, -1, axis=-1))
        inv_dx = (dt_s / dxj)[None, :, None]
        M = u_face * dp_face * inv_dx                     # face mass flux
        c_abs = jnp.abs(u_face) * inv_dx
        up_pos = M >= 0.0

        def substep(carry, _):
            q, dp = carry
            qm = jnp.roll(q, 1, axis=-1)
            qp = jnp.roll(q, -1, axis=-1)
            s = _mc_slope(qm, q, qp)
            sp = jnp.roll(s, -1, axis=-1)
            # upwind from the left cell (M>=0): q_i + 0.5 s_i (1-|c|);
            # from the right cell: q_{i+1} - 0.5 s_{i+1} (1-|c|)
            q_face = jnp.where(up_pos, _vanleer_face(q, s, c_abs),
                               qp - 0.5 * sp * (1.0 - c_abs))
            F = M * q_face
            Q = q * dp - (F - jnp.roll(F, 1, axis=-1))
            dp = dp - (M - jnp.roll(M, 1, axis=-1))
            return (Q / dp, dp), None

        (q, dp), _ = lax.scan(substep, (q, dp), None, length=n)
        return q, dp

    def _zonal(self, q, dp, u, dt):
        qs, dps = [], []
        for (j0, j1, n) in self.zonal_bands:
            qb, dpb = self._zonal_band(
                q[:, j0:j1], dp[:, j0:j1], u[:, j0:j1], self._dx[j0:j1],
                n, dt)
            qs.append(qb)
            dps.append(dpb)
        return (jnp.concatenate(qs, axis=1), jnp.concatenate(dps, axis=1))

    # -- meridional (closed poles, one-row halo) --------------------------
    def _shift_north(self, x):
        """Row j of result = row j-1 of x (northern neighbor); row 0
        zero-padded (pole)."""
        if self.halo_exchange is not None:
            return self.halo_exchange(x, +1)
        return jnp.concatenate([jnp.zeros_like(x[:, :1]), x[:, :-1]],
                               axis=1)

    def _shift_south(self, x):
        if self.halo_exchange is not None:
            return self.halo_exchange(x, -1)
        return jnp.concatenate([x[:, 1:], jnp.zeros_like(x[:, :1])],
                               axis=1)

    def _meridional(self, q, dp, v, dt):
        """Flux-form van Leer in mu.  Face j+1/2 sits between rows j and
        j+1 (mu decreasing); v > 0 (northward) carries mass from row j+1
        to row j."""
        vc = v * self._coslat[None, :, None]
        q_s = self._shift_south(q)                        # row j+1 values
        dp_s = self._shift_south(dp)
        vc_s = self._shift_south(vc)
        nlat = self.nlat
        # interior face mask: faces 0..nlat-2 real, last face = S pole
        face_ok = jnp.arange(nlat) < nlat - 1
        vc_face = 0.5 * (vc + vc_s) * face_ok[None, :, None]
        dp_face = 0.5 * (dp + dp_s)
        # G = v cos * dp * q at faces; update uses (dt/a) (G_{j-1/2} -
        # G_{j+1/2}) / w_j
        wface = jnp.concatenate(
            [self._wface, self._wface[-1:]])[None, :, None]
        c_abs = jnp.abs(vc_face) * dt / (self.radius * wface)

        s = _mc_slope(self._shift_north(q), q, q_s)
        s_s = self._shift_south(s)
        q_face = jnp.where(vc_face <= 0.0,
                           _vanleer_face(q, s, c_abs),
                           q_s - 0.5 * s_s * (1.0 - c_abs))
        G = vc_face * dp_face * q_face                    # face j+1/2
        G_n = self._shift_north(G)                        # face j-1/2
        fac = (dt / self.radius) / self._w[None, :, None]
        Q = q * dp - fac * (G_n - G)
        dp = dp - fac * (self._shift_north(vc_face * dp_face)
                         - vc_face * dp_face)
        return Q / dp, dp

    # -- vertical (upwind on the dycore's interface mass flux) ------------
    def _vertical(self, q, dp, mdot, dt):
        """mdot: (nz-1, nlat, nlon) interface mass flux (Pa/s, positive
        downward/toward larger k in the top-down layout)."""
        q_up = jnp.where(mdot >= 0.0, q[:-1], q[1:])
        F = mdot * q_up * dt                              # interior faces
        zero = jnp.zeros_like(F[:1])
        F_full = jnp.concatenate([zero, F, zero], axis=0)
        M_full = jnp.concatenate([zero, mdot * dt, zero], axis=0)
        Q = q * dp - (F_full[1:] - F_full[:-1])
        dp = dp - (M_full[1:] - M_full[:-1])
        return Q / dp, dp

    # -- full step --------------------------------------------------------
    def advect(self, q, dp, u, v, mdot, dt):
        """One conservative transport step over ``dt`` (<= dt_max).

        q, dp, u, v: (nz, nlat, nlon) top-down; mdot (nz-1, nlat, nlon).
        Returns the transported mixing ratio (the pseudo-density dp* is
        internal; see module docstring).
        """
        q, dp = self._zonal(q, dp, u, dt)
        q, dp = self._meridional(q, dp, v, dt)
        q, _ = self._vertical(q, dp, mdot, dt)
        return q

    def total_mass(self, q, dp):
        """Area-weighted tracer mass sum_ijk q dp w_j (conserved by
        ``advect`` to roundoff; the dlambda/ g factors are constant)."""
        return jnp.sum(q * dp * self._w[None, :, None])
