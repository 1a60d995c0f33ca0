"""Core numerical utilities, written as jit-compatible JAX functions.

Behavioral parity with /root/reference/climt/_core/util.py:
- ``get_interface_values``: log-pressure interpolation of mid-level
  quantities onto interfaces (the CESM radiation.F90 scheme, util.py:84-138).
- ``mass_to_volume_mixing_ratio`` (util.py:41-81).
- ``calculate_q_sat`` / ``bolton_q_sat`` / ``bolton_dqsat_dT``: saturation
  specific humidity with above/below-freezing branches (util.py:141-172) —
  branchless here via ``jnp.where`` so they vectorize.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .dataarray import DataArray


def numpy_version_of(state):
    """Strip DataArrays (and device arrays) down to host numpy arrays."""
    raw = {}
    for name, value in state.items():
        if isinstance(value, DataArray):
            raw[name] = np.asarray(value.values)
        elif hasattr(value, 'shape'):
            raw[name] = np.asarray(value)
    return raw


def jax_version_of(state):
    """Device-array view of a state's values."""
    raw = {}
    for name, value in state.items():
        if isinstance(value, DataArray):
            raw[name] = jnp.asarray(value.values)
        elif hasattr(value, 'shape'):
            raw[name] = jnp.asarray(value)
    return raw


def mass_to_volume_mixing_ratio(
        mass_mixing_ratio, molecular_weight=None,
        molecular_weight_air=28.964):
    """Convert g/g mass mixing ratio to mole/mole volume mixing ratio."""
    if molecular_weight is None:
        raise ValueError('The molecular weight must be provided')
    return mass_mixing_ratio * molecular_weight_air / molecular_weight


def get_interface_values(
        mid_level_values, surface_value,
        mid_level_pressure, interface_level_pressure):
    """Interpolate mid-level values (vertical axis first, length K) onto
    K+1 interfaces using linear-in-log-pressure weights; the bottom interface
    takes the surface value and the top interface the top mid-level value.
    """
    xp = jnp if not isinstance(mid_level_values, np.ndarray) else np
    log_p = xp.log(mid_level_pressure)
    weight = (
        xp.log(interface_level_pressure[1:-1]) - log_p[1:]) / (
        log_p[:-1] - log_p[1:])
    interior = mid_level_values[1:] - weight * (
        mid_level_values[1:] - mid_level_values[:-1])
    return xp.concatenate([
        surface_value[None], interior, mid_level_values[-1:][...]], axis=0)


def calculate_q_sat(surface_temperature, surface_pressure, Rd, Rv):
    """Saturation specific humidity with distinct saturation-vapor-pressure
    fits above and below freezing (Buck-style enhancement factors)."""
    xp = jnp if not isinstance(surface_temperature, np.ndarray) else np
    T = surface_temperature
    p = surface_pressure
    es_warm = (1.0007 + 3.46e-8 * p) * 611.21 * xp.exp(
        17.966 * (T - 273.) / (247.15 + (T - 273.)))
    es_cold = (1.0003 + 4.18e-8 * p) * 611.15 * xp.exp(
        22.452 * (T - 273.) / (272.5 + (T - 273.)))
    es = xp.where(T > 273., es_warm, es_cold)
    eps = Rd / Rv
    return eps * es / (p - (1 - eps) * es)


def bolton_q_sat(T, p, Rd, Rh2O):
    """Bolton (1980) saturation specific humidity."""
    xp = jnp if not isinstance(T, np.ndarray) else np
    es = 611.2 * xp.exp(17.67 * (T - 273.15) / (T - 29.65))
    eps = Rd / Rh2O
    return eps * es / (p - (1 - eps) * es)


def bolton_dqsat_dT(T, Lv, Rh2O, q_sat):
    """d(q_sat)/dT under the Clausius-Clapeyron approximation of Reed &
    Jablonowski (2012), eq. 12: epsilon/p * d(es)/dT."""
    return Lv * q_sat / (Rh2O * T ** 2)
