"""Fused, scan-based production models: dynamics + physics in one jit.

This is the accelerator execution path (SURVEY.md §7 design stance): marshalling
happens once at build time; the model loop is a single compiled
``lax.scan`` over the semi-implicit leapfrog step with physics evaluated
inside the trace from the synthesized grid fields.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core.grid import hybrid_sigma_pressure_coefficients
from .spectral_dynamics import SpectralDycore


def held_suarez_physics_fn(dycore, sigma_b=0.7, k_f=1.0 / 86400.0,
                           k_a=1.0 / 40.0 / 86400.0,
                           k_s=1.0 / 4.0 / 86400.0,
                           delta_T_y=60.0, delta_theta_z=10.0, p0=1e5):
    """Held-Suarez forcing as a pure function of the dycore grid state
    (top-down (nz, nlat, nlon) fields)."""
    mu = np.asarray(dycore.sht.mu)
    lat_rad = np.arcsin(mu)
    coslat2 = jnp.asarray(np.cos(lat_rad) ** 2)[None, :, None]
    coslat4 = coslat2 ** 2
    sinlat2 = jnp.asarray(np.sin(lat_rad) ** 2)[None, :, None]
    kappa = dycore.kappa

    def physics(gs):
        p = 0.5 * (gs['p_half'][1:] + gs['p_half'][:-1])
        sigma = p / gs['ps'][None]
        Teq = jnp.maximum(
            200.0,
            (315.0 - delta_T_y * sinlat2
             - delta_theta_z * jnp.log(p / p0) * coslat2)
            * (p / p0) ** kappa)
        sf = jnp.maximum(0.0, (sigma - sigma_b) / (1.0 - sigma_b))
        k_t = k_a + (k_s - k_a) * sf * coslat4
        k_v = k_f * sf
        return {
            'du': -k_v * gs['u'],
            'dv': -k_v * gs['v'],
            'dT': -k_t * (gs['T'] - Teq),
            'dq': jnp.zeros_like(gs['q']),
        }

    return physics


def build_held_suarez_model(nlon=128, nlat=64, nz=28, timestep=600.0,
                            number_of_damped_levels=5,
                            dtype=jnp.float32):
    """Return (dycore, init_fn, step_fn, run_fn) for the Held-Suarez GCM.

    ``run_fn(prev, now, n_steps)`` is a jitted lax.scan over the
    semi-implicit step with the HS forcing fused in.
    """
    ak, bk = hybrid_sigma_pressure_coefficients(nz + 1, 1e5, 20.0)
    dycore = SpectralDycore(
        nlon, nlat, nz, ak, bk, timestep=timestep,
        number_of_damped_levels=number_of_damped_levels, dtype=dtype)
    physics = held_suarez_physics_fn(dycore)

    @jax.jit
    def _init_from_grids(u, v, T, q, lnps):
        spec = dycore.spectral_state_from_grid(u, v, T, q, lnps)
        prev, now = dycore.initial_step(spec, physics_fn=physics)
        return prev, now, dycore.grids_of(prev)

    def init_fn(seed=0):
        rng = np.random.RandomState(seed)
        shape = (nz, nlat, nlon)
        T = 290.0 + 0.1 * rng.randn(*shape)
        zeros = np.zeros(shape)
        lnps = np.full((nlat, nlon), np.log(1e5))
        return _init_from_grids(
            jnp.asarray(zeros, dtype=dtype), jnp.asarray(zeros, dtype=dtype),
            jnp.asarray(T, dtype=dtype), jnp.asarray(zeros, dtype=dtype),
            jnp.asarray(lnps, dtype=dtype))

    def step_fn(carry, _):
        prev, now, prev_grids = carry
        filtered, new, now_grids = dycore.step(
            prev, now, physics_fn=physics, prev_grids=prev_grids)
        return (filtered, new, now_grids), None

    @partial(jax.jit, static_argnums=(1,))
    def run_fn(carry, n_steps):
        carry, _ = jax.lax.scan(step_fn, carry, None, length=n_steps)
        return carry

    return dycore, init_fn, step_fn, run_fn
