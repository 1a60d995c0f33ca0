"""Simple boundary-layer scheme (Frierson, Held & Zurita-Gotor 2006).

Behavioral parity with
/root/reference/climt/_components/simple_boundary_layer/component.py
(v0.31): simplified Monin-Obukhov diffusivities with a K-profile capped
by a critical Richardson number, an implicit vertical diffusion of T, q,
u, v, and three surface-exchange modes ('bulk' internal fluxes,
'external' prescribed fluxes, None no-flux).  The surface-layer
coefficient uses the surface-layer Richardson number in its multiplier
(the thesis Eqn 2.8 form, continuous at Ri_a = 0).

Vectorized design: the reference's per-column numba loop (including its
early-exit boundary-layer-top search) becomes whole-grid jnp math — the
first-exceedance search is an argmax over a boolean mask, and the four
implicit diffusion solves are batched tridiagonal solves over every
column at once (ops/tridiagonal.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core.base_components import Stepper, timestep_seconds
from ..core.constants import get_constant
from ..ops.tridiagonal import tridiagonal_solve

_FLUX_MODES = {None: 0, 'bulk': 1, 'external': 2}


def _richardson_diffusivity(ri_a, u_fric, c_drag, z, k, z0, ric):
    """Surface-layer diffusion coefficient K_b (thesis Eqn 2.8)."""
    base = k * u_fric * jnp.sqrt(c_drag) * z
    stable = base / (1.0 + ri_a / ric * jnp.log(z / z0)
                     / (1.0 - ri_a / ric))
    return jnp.where(ri_a <= 0.0, base, stable)


def _diffuse_profile(profile, p, p_int, rho, diff, dt, g,
                     surface_exchange, surface_source):
    """Implicit vertical diffusion with a surface boundary term; all
    arrays are (levels, ncol).  rho/diff live on the nz-1 interior
    interfaces.  Mirrors the reference _diffuse_profile exactly."""
    nz = profile.shape[0]
    zeros_row = jnp.zeros((1,) + profile.shape[1:], profile.dtype)
    diag_m = jnp.concatenate([
        zeros_row,
        g * g * rho * rho * diff * dt
        / (p[:-1] - p[1:]) / (p_int[1:-1] - p_int[2:]),
    ], axis=0)
    diag_p = jnp.concatenate([
        g * g * rho * rho * diff * dt
        / (p[:-1] - p[1:]) / (p_int[:-2] - p_int[1:-1]),
        zeros_row,
    ], axis=0)
    diag = 1.0 + diag_m + diag_p
    diag = diag.at[0].add(surface_exchange)
    rhs = profile.at[0].add(surface_source)
    return tridiagonal_solve(-diag_m, diag, -diag_p, rhs)


@functools.partial(jax.jit, static_argnames=('flux_mode',))
def boundary_layer_step(T, Ts, p, p_int, ps, q, qs, v, u,
                        sensible_in, latent_in, dt, flux_mode,
                        Rd, Cp, g, k, z0, fb, P0, Ric, Lv):
    """One SimpleBoundaryLayer step over all columns.

    Shapes: profiles (nz, ncol), p_int (nz+1, ncol), surface fields
    (ncol,).  Returns (new_T, new_q, new_v, new_u, stress_n, stress_e,
    bl_height, applied_sensible, applied_latent).
    """
    v_int = 0.5 * (v[1:] + v[:-1])
    u_int = 0.5 * (u[1:] + u[:-1])
    T_int = 0.5 * (T[1:] + T[:-1])
    q_int = 0.5 * (q[1:] + q[:-1])
    p_mid_int = p_int[1:-1]
    rho = p_mid_int / (Rd * (1.0 + 0.608 * q_int) * T_int)

    pot_virt = (T_int * (P0 / p_mid_int) ** (Rd / Cp)
                * (1.0 + 0.608 * q_int))
    pot_virt_surf = Ts * (P0 / ps) ** (Rd / Cp) * (1.0 + 0.608 * qs)

    # interior-interface heights by hydrostatic integration
    dz0 = (Rd * (1.0 + 0.608 * q[0]) * T[0] / g) * jnp.log(ps / p_mid_int[0])
    dzs = (Rd * (1.0 + 0.608 * q[1:-1]) * T[1:-1] / g
           * jnp.log(p_mid_int[:-1] / p_mid_int[1:]))
    z = jnp.concatenate([dz0[None], dzs], axis=0).cumsum(axis=0)

    wind_int = jnp.maximum(jnp.sqrt(v_int ** 2 + u_int ** 2), 1.0)

    ri_a = (g * z[0] * (pot_virt[0] - pot_virt_surf)
            / (pot_virt_surf * wind_int[0] ** 2))
    log_term = jnp.log(z[0] / z0) ** -2
    c_drag = jnp.where(
        ri_a < 0.0, k * k * log_term,
        jnp.where(ri_a < Ric,
                  k * k * log_term * (1.0 - ri_a / Ric) ** 2, 0.0))

    # boundary-layer top: first interface whose local Ri exceeds Ric
    # (the reference's early-exit loop; count==0 when none do, which
    # makes h = z[-1] via negative indexing — replicated here)
    rich = (g * z * (pot_virt - pot_virt[0])
            / (pot_virt[0] * wind_int ** 2))
    exceed = rich > Ric
    found = exceed.any(axis=0)
    first = jnp.argmax(exceed, axis=0)
    count = jnp.where(found, first + 1, 0)
    n = z.shape[0]
    h = jnp.take_along_axis(
        z, jnp.where(found, first, n - 1)[None], axis=0)[0]

    u_fric = wind_int[0]
    dp0 = p_int[0] - p_int[1]
    bulk_conductance = rho[0] * c_drag * wind_int[0]
    beta = g * bulk_conductance * dt / dp0

    if flux_mode == 1:
        scalar_exchange = beta
        source_T = beta * Ts
        source_q = beta * qs
    elif flux_mode == 2:
        scalar_exchange = jnp.zeros_like(beta)
        source_T = g * dt * sensible_in / (Cp * dp0)
        source_q = g * dt * latent_in / (Lv * dp0)
    else:
        scalar_exchange = jnp.zeros_like(beta)
        source_T = jnp.zeros_like(beta)
        source_q = jnp.zeros_like(beta)
    wind_exchange = jnp.zeros_like(beta) if flux_mode == 0 else beta

    # K-profile: surface-layer form below fb*h, decaying profile above;
    # zero at and above the boundary-layer top (i >= count)
    level = jnp.arange(n)[:, None]
    in_bl = level < count[None, :]
    k_surf = _richardson_diffusivity(ri_a, u_fric, c_drag, z, k, z0, Ric)
    k_top = _richardson_diffusivity(ri_a, u_fric, c_drag, fb * h,
                                    k, z0, Ric)
    k_prof = (k_top * z / (h * fb)
              * (1.0 - (z - fb * h) / ((1.0 - fb) * h)) ** 2)
    diff = jnp.where(z < fb * h, k_surf, k_prof)
    diff = jnp.where(in_bl, diff, 0.0)

    new_T = _diffuse_profile(T, p, p_int, rho, diff, dt, g,
                             scalar_exchange, source_T)
    new_q = _diffuse_profile(q, p, p_int, rho, diff, dt, g,
                             scalar_exchange, source_q)
    new_v = _diffuse_profile(v, p, p_int, rho, diff, dt, g,
                             wind_exchange, jnp.zeros_like(beta))
    new_u = _diffuse_profile(u, p, p_int, rho, diff, dt, g,
                             wind_exchange, jnp.zeros_like(beta))

    applied_sensible = Cp * bulk_conductance * (Ts - new_T[0])
    applied_latent = Lv * bulk_conductance * (qs - new_q[0])
    stress_n = bulk_conductance * new_v[0]
    stress_e = bulk_conductance * new_u[0]
    return (new_T, new_q, new_v, new_u, stress_n, stress_e, h,
            applied_sensible, applied_latent)


class SimpleBoundaryLayer(Stepper):
    """Boundary-layer diffusion of heat, moisture and momentum with
    Frierson (2006) surface exchange (see module docstring for the three
    ``surface_fluxes`` modes)."""

    input_properties = {
        'air_temperature': {'dims': ['mid_levels', '*'], 'units': 'degK'},
        'specific_humidity': {
            'dims': ['mid_levels', '*'], 'units': 'kg/kg'},
        'air_pressure': {'dims': ['mid_levels', '*'], 'units': 'Pa'},
        'air_pressure_on_interface_levels': {
            'dims': ['interface_levels', '*'], 'units': 'Pa'},
        'northward_wind': {'dims': ['mid_levels', '*'], 'units': 'm s^-1'},
        'eastward_wind': {'dims': ['mid_levels', '*'], 'units': 'm s^-1'},
        'surface_air_pressure': {'dims': ['*'], 'units': 'Pa'},
        'surface_temperature': {'dims': ['*'], 'units': 'degK'},
        'surface_specific_humidity': {'dims': ['*'], 'units': 'kg/kg'},
    }

    output_properties = {
        'air_temperature': {'dims': ['mid_levels', '*'], 'units': 'degK'},
        'specific_humidity': {
            'dims': ['mid_levels', '*'], 'units': 'kg/kg'},
        'northward_wind': {'dims': ['mid_levels', '*'], 'units': 'm s^-1'},
        'eastward_wind': {'dims': ['mid_levels', '*'], 'units': 'm s^-1'},
    }

    diagnostic_properties = {
        'northward_wind_stress': {'dims': ['*'], 'units': 'Pa'},
        'eastward_wind_stress': {'dims': ['*'], 'units': 'Pa'},
        'boundary_layer_height': {'dims': ['*'], 'units': 'm'},
    }

    def __init__(self, surface_fluxes='bulk', von_karman_constant=0.4,
                 roughness_length=0.0000321, specific_fraction=0.1,
                 reference_pressure=100000, critical_richardson_number=1,
                 **kwargs):
        """surface_fluxes: 'bulk' (internal implicit bulk fluxes,
        reported as diagnostics), 'external' (prescribed flux inputs), or
        None (no surface exchange; conservative no-flux boundaries)."""
        if surface_fluxes not in _FLUX_MODES:
            raise ValueError(
                "surface_fluxes must be 'bulk', 'external' or None, "
                'got {!r}'.format(surface_fluxes))
        self._flux_mode = _FLUX_MODES[surface_fluxes]
        self._k = von_karman_constant
        self._z0 = roughness_length
        self._fb = specific_fraction
        self._P0 = reference_pressure
        self._Ric = critical_richardson_number
        if surface_fluxes == 'bulk':
            self.diagnostic_properties = dict(self.diagnostic_properties)
            self.diagnostic_properties.update({
                'surface_upward_sensible_heat_flux': {
                    'dims': ['*'], 'units': 'W m^-2'},
                'surface_upward_latent_heat_flux': {
                    'dims': ['*'], 'units': 'W m^-2'},
            })
        elif surface_fluxes == 'external':
            self.input_properties = dict(self.input_properties)
            self.input_properties.update({
                'surface_upward_sensible_heat_flux': {
                    'dims': ['*'], 'units': 'W m^-2'},
                'surface_upward_latent_heat_flux': {
                    'dims': ['*'], 'units': 'W m^-2'},
            })
        super().__init__(**kwargs)

    def array_call(self, state, timestep):
        dt = timestep_seconds(timestep)
        Rd = get_constant('gas_constant_of_dry_air', 'J kg^-1 K^-1')
        Cp = get_constant(
            'heat_capacity_of_dry_air_at_constant_pressure', 'J kg^-1 K^-1')
        g = get_constant('gravitational_acceleration', 'm s^-2')
        Lv = get_constant('latent_heat_of_condensation', 'J kg^-1')

        ncol = np.asarray(state['air_temperature']).shape[1]
        zeros = jnp.zeros(ncol)
        if self._flux_mode == 2:
            sensible = jnp.asarray(
                state['surface_upward_sensible_heat_flux'])
            latent = jnp.asarray(state['surface_upward_latent_heat_flux'])
        else:
            sensible = latent = zeros

        (new_T, new_q, new_v, new_u, stress_n, stress_e, h,
         applied_sensible, applied_latent) = boundary_layer_step(
            jnp.asarray(state['air_temperature']),
            jnp.asarray(state['surface_temperature']),
            jnp.asarray(state['air_pressure']),
            jnp.asarray(state['air_pressure_on_interface_levels']),
            jnp.asarray(state['surface_air_pressure']),
            jnp.asarray(state['specific_humidity']),
            jnp.asarray(state['surface_specific_humidity']),
            jnp.asarray(state['northward_wind']),
            jnp.asarray(state['eastward_wind']),
            sensible, latent, dt, self._flux_mode,
            Rd, Cp, g, self._k, self._z0, self._fb, self._P0,
            self._Ric, Lv)

        new_state = {
            'air_temperature': new_T,
            'specific_humidity': new_q,
            'northward_wind': new_v,
            'eastward_wind': new_u,
        }
        diagnostics = {
            'northward_wind_stress': stress_n,
            'eastward_wind_stress': stress_e,
            'boundary_layer_height': h,
        }
        if self._flux_mode == 1:
            diagnostics['surface_upward_sensible_heat_flux'] = \
                applied_sensible
            diagnostics['surface_upward_latent_heat_flux'] = applied_latent
        return diagnostics, new_state
