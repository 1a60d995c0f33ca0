"""Conservative dry convective adjustment.

Behavioral parity with
/root/reference/climt/_components/dry_convection/component.py:7-130: sweep
levels from model top downward; at each level, find the highest layer such
that the running mass-weighted mean of the moisture-weighted potential
temperature theta_q exceeds the environment above, and mix specific humidity
(mass-weighted mean) and enthalpy (redistributed along the dry adiabat with
moisture-dependent Cp and R) over that slab.

Vectorized design: the reference's per-column per-level nested Python loops
(:71-114) become a ``lax.fori_loop`` over levels carrying the (T, q) state of
ALL columns at once; each iteration uses masked cumulative sums over the
(small) level axis, so the work is O(nz^2) elementwise ops with no
data-dependent shapes.  The instability measure theta_q is evaluated from the
*initial* profile (as the reference does), while mixing reads the running
state.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..core.base_components import Stepper
from ..core.constants import get_constant


def _heat_capacity(q, cpd, cvap):
    return cpd * (1.0 - q) + cvap * q


def _gas_constant(q, rd, rv):
    return rd * (1.0 - q) + rv * q


@partial(jax.jit, static_argnames=())
def dry_convective_adjustment(T, q, p, p_int, cpd, cvap, rd, rv, p_ref):
    """Adjust (T, q) of shape (nz, ncol); level 0 is the lowest layer."""
    nz = T.shape[0]
    k_idx = jnp.arange(nz)[:, None]  # level index column vector

    dp = p_int[:-1] - p_int[1:]  # positive layer thickness
    rd_cp0 = _gas_constant(q, rd, rv) / _heat_capacity(q, cpd, cvap)
    theta = T * (p_ref / p) ** rd_cp0
    # moisture-weighted (virtual-like) potential temperature, fixed for the
    # whole sweep as in the reference
    theta_q = theta * (1.0 + q * rv / rd - q)

    def body(i, carry):
        T_cur, q_cur = carry
        level = nz - 1 - i

        above = k_idx >= level  # layers from `level` upward
        # running mean of theta_q over [level, k]
        masked_tq = jnp.where(above, theta_q, 0.0)
        csum = jnp.cumsum(masked_tq, axis=0)
        count = (k_idx - level + 1).astype(T_cur.dtype)
        theta_avg = csum / jnp.maximum(count, 1.0)
        # instability: mean over [level, k] exceeds theta_q at k, for k>level
        unstable = (theta_avg > theta_q) & (k_idx > level)
        any_unstable = jnp.any(unstable, axis=0)
        # highest unstable layer index
        k_last = jnp.max(jnp.where(unstable, k_idx, -1), axis=0)
        # mixing range is [level, stable_level) with stable_level = k_last,
        # except at the surface where at least one layer mixes
        stable_level = jnp.where(
            (level == 0) & (k_last <= level), level + 1, k_last)
        do_mix = any_unstable & (stable_level > level)

        in_range = (k_idx >= level) & (k_idx < stable_level)
        w = jnp.where(in_range, dp, 0.0)

        cp_old = _heat_capacity(q_cur, cpd, cvap)
        integral_enthalpy = jnp.sum(cp_old * T_cur * w, axis=0)
        p_top_minus_bottom = jnp.sum(w, axis=0)  # = P_int[level]-P_int[stable]
        mean_q = jnp.sum(q_cur * w, axis=0) / jnp.maximum(
            p_top_minus_bottom, 1e-30)

        rdcp_conv = (_gas_constant(mean_q, rd, rv)
                     / _heat_capacity(mean_q, cpd, cvap))
        theta_coeff = (p / p_ref) ** rdcp_conv[None, :]
        integral_theta_den = jnp.sum(cp_old * theta_coeff * w, axis=0)
        mean_theta = integral_enthalpy / jnp.maximum(
            integral_theta_den, 1e-30)

        new_T = jnp.where(in_range & do_mix, mean_theta * theta_coeff, T_cur)
        new_q = jnp.where(in_range & do_mix, mean_q[None, :], q_cur)
        return new_T, new_q

    T_out, q_out = jax.lax.fori_loop(0, nz, body, (T, q))
    return T_out, q_out


class DryConvectiveAdjustment(Stepper):
    """Keep the temperature profile from being super-adiabatic, conserving
    enthalpy and moisture."""

    input_properties = {
        'air_temperature': {'units': 'degK', 'dims': ['mid_levels', '*']},
        'air_pressure': {'units': 'Pa', 'dims': ['mid_levels', '*']},
        'air_pressure_on_interface_levels': {
            'units': 'Pa', 'dims': ['interface_levels', '*'],
            'alias': 'P_int'},
        'specific_humidity': {'units': 'kg/kg', 'dims': ['mid_levels', '*']},
    }

    output_properties = {
        'air_temperature': {'units': 'degK'},
        'specific_humidity': {'units': 'kg/kg'},
    }

    diagnostic_properties = {}

    def array_call(self, state, timestep):
        T_out, q_out = dry_convective_adjustment(
            jnp.asarray(state['air_temperature']),
            jnp.asarray(state['specific_humidity']),
            jnp.asarray(state['air_pressure']),
            jnp.asarray(state['P_int']),
            get_constant('heat_capacity_of_dry_air_at_constant_pressure',
                         'J/kg/degK'),
            get_constant('heat_capacity_of_vapor_phase', 'J/kg/K'),
            get_constant('gas_constant_of_dry_air', 'J/kg/degK'),
            get_constant('gas_constant_of_vapor_phase', 'J/kg/K'),
            get_constant('reference_air_pressure', 'Pa'))
        return {}, {'air_temperature': T_out, 'specific_humidity': q_out}
