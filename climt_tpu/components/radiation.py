"""Grey-gas longwave radiation and the Frierson-06 optical depth.

Behavioral parity with /root/reference/climt/_components/radiation.py:
- ``GrayLongwaveRadiation``: two-sweep grey radiative transfer over interface
  levels, F_{k+1} = F_k e^{-dtau} + sigma T^4 (1 - e^{-dtau}) upward from the
  surface and the mirror recurrence downward from the top (kernels at
  radiation.py:143-204); heating rate = g/Cp * d(F_net)/dp.
- ``Frierson06LongwaveOpticalDepth``: tau(lat, sigma) = tau0(lat) *
  (1 - (f_l sigma + (1-f_l) sigma^4)), tau0 = tau0e + (tau0p - tau0e) sin^2(lat)
  (radiation.py:208-211).

Vectorized design: the vertical sweeps are first-order linear recurrences
expressed as ``lax.scan`` over the (short) level axis with the full flattened
column axis vectorized; everything is jit-compatible and
dtype-polymorphic (f64 for validation, f32/bf16 in production).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.base_components import DiagnosticComponent, TendencyComponent
from ..core.constants import get_constant


def upward_longwave_flux(T, T_surface, tau, sigma_sb):
    """Upward grey LW flux on interfaces (level axis first, bottom first)."""
    dtau = tau[1:] - tau[:-1]
    trans = jnp.exp(-dtau)
    source = sigma_sb * T ** 4 * (1.0 - trans)
    f0 = sigma_sb * T_surface ** 4

    def step(flux, inputs):
        t, s = inputs
        flux = flux * t + s
        return flux, flux

    _, fluxes = jax.lax.scan(step, f0, (trans, source))
    return jnp.concatenate([f0[None], fluxes], axis=0)


def downward_longwave_flux(T, tau, sigma_sb):
    """Downward grey LW flux on interfaces (zero at top of atmosphere)."""
    dtau = tau[1:] - tau[:-1]
    trans = jnp.exp(-dtau)
    source = sigma_sb * T ** 4 * (1.0 - trans)
    top = jnp.zeros_like(T[0])

    def step(flux, inputs):
        t, s = inputs
        flux = flux * t + s
        return flux, flux

    _, fluxes = jax.lax.scan(step, top, (trans, source), reverse=True)
    return jnp.concatenate([fluxes, top[None]], axis=0)


@jax.jit
def gray_longwave_fluxes(T, p_interface, T_surface, tau, sigma_sb, g, cpd):
    upward = upward_longwave_flux(T, T_surface, tau, sigma_sb)
    downward = downward_longwave_flux(T, tau, sigma_sb)
    net = upward - downward
    tendency = (g / cpd) * (net[1:] - net[:-1]) / (
        p_interface[1:] - p_interface[:-1])
    return downward, upward, net, tendency


class GrayLongwaveRadiation(TendencyComponent):

    input_properties = {
        'longwave_optical_depth_on_interface_levels': {
            'dims': ['interface_levels', '*'],
            'units': 'dimensionless',
            'alias': 'tau',
        },
        'air_temperature': {
            'dims': ['mid_levels', '*'],
            'units': 'degK',
            'alias': 'sl',
        },
        'surface_temperature': {
            'dims': ['*'],
            'units': 'degK',
            'alias': 'T_surface',
        },
        'air_pressure': {
            'dims': ['mid_levels', '*'],
            'units': 'Pa',
            'alias': 'p',
        },
        'air_pressure_on_interface_levels': {
            'dims': ['interface_levels', '*'],
            'units': 'Pa',
            'alias': 'p_interface',
        },
    }

    diagnostic_properties = {
        'downwelling_longwave_flux_in_air': {
            'dims': ['interface_levels', '*'],
            'units': 'W m^-2',
            'alias': 'lw_down',
        },
        'upwelling_longwave_flux_in_air': {
            'dims': ['interface_levels', '*'],
            'units': 'W m^-2',
            'alias': 'lw_up',
        },
        'air_temperature_tendency_from_longwave': {
            'dims': ['mid_levels', '*'],
            'units': 'degK day^-1',
        },
    }

    tendency_properties = {
        'air_temperature': {'units': 'degK s^-1'},
    }

    def array_call(self, state):
        sigma_sb = get_constant('stefan_boltzmann_constant', 'W/m^2/K^4')
        g = get_constant('gravitational_acceleration', 'm/s^2')
        cpd = get_constant(
            'heat_capacity_of_dry_air_at_constant_pressure', 'J/kg/K')
        downward, upward, _, tendency = gray_longwave_fluxes(
            jnp.asarray(state['sl']), jnp.asarray(state['p_interface']),
            jnp.asarray(state['T_surface']), jnp.asarray(state['tau']),
            sigma_sb, g, cpd)
        tendencies = {'sl': tendency}
        diagnostics = {
            'lw_down': downward,
            'lw_up': upward,
            'air_temperature_tendency_from_longwave': tendency * 86400.,
        }
        return tendencies, diagnostics


@jax.jit
def frierson_tau(latitude_deg, sigma, tau0e, tau0p, fl):
    """Frierson et al. (2006) grey optical depth profile."""
    xp = jnp
    tau0 = tau0e + (tau0p - tau0e) * xp.sin(
        latitude_deg * jnp.pi / 180.0) ** 2
    return tau0 * (1.0 - (fl * sigma + (1.0 - fl) * sigma ** 4))


class Frierson06LongwaveOpticalDepth(DiagnosticComponent):

    input_properties = {
        'air_pressure_on_interface_levels': {
            'dims': ['interface_levels', '*'],
            'units': 'Pa',
        },
        'surface_air_pressure': {
            'dims': ['*'],
            'units': 'Pa',
        },
        'latitude': {
            'dims': ['*'],
            'units': 'degrees_N',
        },
    }

    diagnostic_properties = {
        'longwave_optical_depth_on_interface_levels': {
            'dims': ['interface_levels', '*'],
            'units': 'dimensionless',
        },
    }

    def __init__(self, linear_optical_depth_parameter=0.1,
                 longwave_optical_depth_at_equator=6,
                 longwave_optical_depth_at_poles=1.5, **kwargs):
        self._fl = linear_optical_depth_parameter
        self._tau0e = longwave_optical_depth_at_equator
        self._tau0p = longwave_optical_depth_at_poles
        super().__init__(**kwargs)

    def array_call(self, state):
        sigma = (jnp.asarray(state['air_pressure_on_interface_levels'])
                 / jnp.asarray(state['surface_air_pressure'])[None, :])
        return {
            'longwave_optical_depth_on_interface_levels': frierson_tau(
                jnp.asarray(state['latitude']), sigma,
                self._tau0e, self._tau0p, self._fl),
        }
