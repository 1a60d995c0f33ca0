"""Held-Suarez (1994) idealized forcing.

Behavioral parity with /root/reference/climt/_components/held_suarez.py:5-174:
Newtonian relaxation of temperature toward the analytic equilibrium
Teq(lat, p) (:157-163) and Rayleigh damping of winds below sigma_b, with the
standard HS94 coefficients as defaults.  Pure elementwise math, fully fused by XLA.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.base_components import TendencyComponent
from ..core.constants import get_constant


@jax.jit
def held_suarez_forcing(u, v, T, p, ps, latitude,
                        sigma_b, k_f, k_a, k_s, delta_T_y, delta_theta_z,
                        p0, kappa):
    lat_rad = jnp.deg2rad(latitude)[:, None]
    sigma = p / ps[:, None]

    Teq = jnp.maximum(
        200.0,
        (315.0 - delta_T_y * jnp.sin(lat_rad) ** 2
         - delta_theta_z * jnp.log(p / p0) * jnp.cos(lat_rad) ** 2)
        * (p / p0) ** kappa)

    sigma_factor = jnp.maximum(0.0, (sigma - sigma_b) / (1.0 - sigma_b))
    k_t = k_a + (k_s - k_a) * sigma_factor * jnp.cos(lat_rad) ** 4
    k_v = k_f * sigma_factor

    return -k_v * u, -k_v * v, -k_t * (T - Teq)


class HeldSuarez(TendencyComponent):
    """Held & Suarez (1994) dynamical-core intercomparison forcing."""

    input_properties = {
        'eastward_wind': {'dims': ['*', 'mid_levels'], 'units': 'm s^-1'},
        'northward_wind': {'dims': ['*', 'mid_levels'], 'units': 'm s^-1'},
        'air_temperature': {'dims': ['*', 'mid_levels'], 'units': 'degK'},
        'air_pressure': {'dims': ['*', 'mid_levels'], 'units': 'Pa'},
        'surface_air_pressure': {'dims': ['*'], 'units': 'Pa'},
        'latitude': {'dims': ['*'], 'units': 'degrees_north'},
    }

    tendency_properties = {
        'eastward_wind': {'units': 'm s^-2'},
        'northward_wind': {'units': 'm s^-2'},
        'air_temperature': {'units': 'degK s^-1'},
    }

    diagnostic_properties = {}

    def __init__(self,
                 sigma_boundary_layer_top=0.7,
                 k_f=1 / 86400.,
                 k_a=1 / 40. / 86400.,
                 k_s=1 / 4. / 86400.,
                 equator_pole_temperature_difference=60,
                 delta_theta_z=10,
                 **kwargs):
        self._sigma_b = sigma_boundary_layer_top
        self._k_f = k_f
        self._k_a = k_a
        self._k_s = k_s
        self._delta_T_y = equator_pole_temperature_difference
        self._delta_theta_z = delta_theta_z
        super().__init__(**kwargs)

    def array_call(self, raw_state):
        p0 = get_constant('reference_air_pressure', 'Pa')
        cpd = get_constant(
            'heat_capacity_of_dry_air_at_constant_pressure', 'J/kg/degK')
        rd = get_constant('gas_constant_of_dry_air', 'J/kg/degK')
        du, dv, dT = held_suarez_forcing(
            jnp.asarray(raw_state['eastward_wind']),
            jnp.asarray(raw_state['northward_wind']),
            jnp.asarray(raw_state['air_temperature']),
            jnp.asarray(raw_state['air_pressure']),
            jnp.asarray(raw_state['surface_air_pressure']),
            jnp.asarray(raw_state['latitude']),
            self._sigma_b, self._k_f, self._k_a, self._k_s,
            self._delta_T_y, self._delta_theta_z, p0, rd / cpd)
        return ({'eastward_wind': du, 'northward_wind': dv,
                 'air_temperature': dT}, {})
