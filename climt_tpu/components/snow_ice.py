"""SeaIce and LandIce: 1-D thermodynamic snow/ice columns, plus the
deprecated IceSheet dispatching shim.

Reference behavior: /root/reference/climt/_components/sea_ice/component.py
and land_ice/component.py (v0.31), both built on the shared implicit
Crank-Nicolson column solver (_core/snow_ice_column.py).  Relative to
the old IceSheet monolith they carry deliberate defect fixes: SeaIce's
basal boundary is a prescribed ocean heat flux (Neumann) instead of a
freezing Dirichlet condition, thicknesses are clamped non-negative (the
excess energy routed into the ocean heat flux), albedos are
configurable, and negative melt energy is clamped with a debug log.

Vectorized design: the reference's per-column numba prange loop becomes
one batched tridiagonal solve over all columns (ops/tridiagonal.py);
the per-column data-dependent branches (melting top boundary, the
conditional cool-and-resolve pass) are evaluated as a second batched
solve selected per column with ``jnp.where`` — at most two solves per
step regardless of grid size, fully vectorized over columns.
"""

from __future__ import annotations

import logging

import jax
import jax.numpy as jnp
import numpy as np

from ..core.base_components import Stepper, timestep_seconds
from ..core.constants import get_constant
from ..ops.tridiagonal import tridiagonal_solve

logger = logging.getLogger(__name__)

_EPSILON = 1e-5


def _round6(x):
    """Match the reference's round(x, 6) on the growth/melt energies."""
    return jnp.round(x * 1e6) / 1e6


def _solve_columns(rho, cp, kappa, temp, dt, dz,
                   top_dirichlet, top_val, bot_dirichlet, bot_val):
    """Batched Crank-Nicolson column solve with per-column boundary types.

    Arrays are (n_layers[, ncol]); index 0 is the column BOTTOM.  rho /
    cp / kappa live on the n_layers-1 material layers between nodes.
    top/bot_dirichlet are per-column booleans: True applies a Dirichlet
    value, False a downward-into-the-column flux (Neumann) condition.
    Mirrors _core/snow_ice_column.py:_solve_column_kernel exactly.
    """
    heat_capacity = rho * cp
    hc_int = 0.5 * (heat_capacity[:-1] + heat_capacity[1:])
    k_int = 0.5 * (kappa[:-1] + kappa[1:])
    mu_inv = dt / (hc_int * 2.0 * dz * dz)

    r = jnp.zeros_like(temp).at[1:-1].set(k_int * mu_inv)
    dp = 1.0 + 2.0 * r
    dm = 1.0 - 2.0 * r
    a_sub = jnp.zeros_like(temp).at[1:-1].set(-mu_inv * kappa[:-1])
    a_sup = jnp.zeros_like(temp).at[1:-1].set(-mu_inv * kappa[1:])

    rhs = dm * temp
    rhs = rhs.at[1:-1].add(mu_inv * kappa[:-1] * temp[:-2]
                           + mu_inv * kappa[1:] * temp[2:])

    # top boundary (node n-1)
    a_sub = a_sub.at[-1].set(jnp.where(top_dirichlet, 0.0, 1.0))
    dp = dp.at[-1].set(jnp.where(top_dirichlet, 1.0, -1.0))
    a_sup = a_sup.at[-1].set(0.0)
    rhs = rhs.at[-1].set(jnp.where(top_dirichlet, top_val,
                                   -top_val * dz / kappa[-1]))

    # bottom boundary (node 0)
    a_sup = a_sup.at[0].set(jnp.where(bot_dirichlet, 0.0, 1.0))
    dp = dp.at[0].set(jnp.where(bot_dirichlet, 1.0, -1.0))
    a_sub = a_sub.at[0].set(0.0)
    rhs = rhs.at[0].set(jnp.where(bot_dirichlet, bot_val,
                                  -bot_val * dz / kappa[0]))

    return tridiagonal_solve(a_sub, dp, a_sup, rhs)


@jax.jit
def _snow_ice_step(active, temp_in, ice_in, snow_in, net_flux,
                   bot_dirichlet, bot_val, dt,
                   rho_ice, rho_snow, c_ice, c_snow, k_ice, k_snow,
                   lf, t_melt, albedo_snow, albedo_ice, albedo_melt,
                   clamp_to_flux):
    """Shared sea-ice / land-ice column step over all columns at once.

    bot_dirichlet/bot_val: per-column basal boundary (LandIce: Dirichlet
    soil temperature; SeaIce: flux -q_ocean).  clamp_to_flux selects
    SeaIce's thickness clamp that routes the excess melt energy into the
    returned basal flux (LandIce clamps both thicknesses plainly).

    Returns (temp, ice, snow, surface_T, heights, basal_flux,
    surface_flux, albedo, neg_energy).
    """
    n_layers = temp_in.shape[0]
    n_mat = n_layers - 1

    total_in = ice_in + snow_in
    safe_height = jnp.where(active, total_in, 1.0)
    dz = safe_height / n_layers
    snow_fraction = snow_in / safe_height
    level_idx = jnp.arange(n_mat)[:, None]
    snow_level = ((1.0 - snow_fraction) * n_layers).astype(jnp.int32) - 1
    is_snow = level_idx > snow_level[None, :]

    rho = jnp.where(is_snow, rho_snow, rho_ice)
    cp = jnp.where(is_snow, c_snow, c_ice)
    kappa = jnp.where(is_snow, k_snow, k_ice)

    surf0 = temp_in[-1]
    check_melting = surf0 >= t_melt - _EPSILON

    # first solve: melting surface -> Dirichlet T_melt, else flux
    new_temp = _solve_columns(
        rho, cp, kappa, temp_in, dt, dz,
        check_melting, jnp.where(check_melting, t_melt, net_flux),
        bot_dirichlet, bot_val)

    flux_through = ((new_temp[-1] - new_temp[-2])
                    * (kappa[-1] + kappa[-2]) * 0.5 / dz)
    # cool-and-resolve: melting surface but conduction exceeds forcing
    need_resolve = (surf0 > t_melt - _EPSILON) & (flux_through > net_flux)
    cooled = temp_in.at[-1].add(
        jnp.where(need_resolve, -10.0 * _EPSILON, 0.0))
    resolved = _solve_columns(
        rho, cp, kappa, cooled, dt, dz,
        jnp.zeros_like(check_melting), net_flux,      # flux top everywhere
        bot_dirichlet, bot_val)
    new_temp = jnp.where(need_resolve[None, :], resolved, new_temp)
    check_melting = check_melting & ~need_resolve

    # basal fluxes
    basal_grad_flux = _round6((new_temp[1] - new_temp[0])
                              * (kappa[0] + kappa[1]) * 0.5 / dz)
    ground_flux = (new_temp[0] - new_temp[1]) * kappa[0] / dz

    # SeaIce: basal growth/melt from the conducted flux at the base
    growth = -(basal_grad_flux * dt / (rho[0] * lf))
    ice = jnp.where(clamp_to_flux, ice_in + growth, ice_in)
    basal_flux_out = basal_grad_flux

    # surface conducted flux after the final solve
    flux_through = ((new_temp[-1] - new_temp[-2])
                    * (kappa[-1] + kappa[-2]) * 0.5 / dz)

    # surface melt
    energy_to_melt = _round6((net_flux - flux_through) * dt)
    neg_energy = check_melting & (energy_to_melt < 0.0)
    energy_to_melt = jnp.maximum(energy_to_melt, 0.0)
    melt_height = jnp.where(check_melting,
                            energy_to_melt / (rho[-1] * lf), 0.0)
    snow_melted_out = melt_height > snow_in
    snow = jnp.where(check_melting,
                     jnp.where(snow_melted_out, 0.0, snow_in - melt_height),
                     snow_in)
    ice = jnp.where(check_melting & snow_melted_out,
                    ice - (melt_height - snow_in), ice)

    # thickness clamping
    pre_clip = ice
    ice = jnp.maximum(ice, 0.0)
    leftover = jnp.where(pre_clip < 0.0, -pre_clip * rho[-1] * lf / dt, 0.0)
    basal_flux_out = jnp.where(clamp_to_flux,
                               basal_flux_out + leftover, basal_flux_out)
    snow = jnp.maximum(snow, 0.0)

    total_out = ice + snow
    iface = jnp.arange(n_layers)[:, None]
    heights = total_out[None, :] * iface / (n_layers - 1)

    albedo = jnp.where(snow > 0.0, albedo_snow, albedo_ice)
    albedo = jnp.where(melt_height > 0.0, albedo_melt, albedo)

    return (new_temp, ice, snow, new_temp[-1], heights, basal_flux_out,
            flux_through, ground_flux, albedo, neg_energy)


_FLUX_PROPS_2D = {
    'downwelling_longwave_flux_in_air': {
        'dims': ['*', 'interface_levels'], 'units': 'W m^-2'},
    'downwelling_shortwave_flux_in_air': {
        'dims': ['*', 'interface_levels'], 'units': 'W m^-2'},
    'upwelling_longwave_flux_in_air': {
        'dims': ['*', 'interface_levels'], 'units': 'W m^-2'},
    'upwelling_shortwave_flux_in_air': {
        'dims': ['*', 'interface_levels'], 'units': 'W m^-2'},
}


class _SnowIceBase(Stepper):
    def __init__(self, maximum_snow_ice_height=10, albedo_snow=0.8,
                 albedo_ice=0.5, albedo_melt=0.2, **kwargs):
        """maximum_snow_ice_height caps the combined snow+ice column (m);
        the three albedos (snow / bare ice / melting surface) are
        configurable rather than the monolith's hardcoded values."""
        self._max_height = maximum_snow_ice_height
        self._albedo_snow = albedo_snow
        self._albedo_ice = albedo_ice
        self._albedo_melt = albedo_melt
        super().__init__(**kwargs)

    def _constants(self):
        return dict(
            k_ice=get_constant(
                'thermal_conductivity_of_solid_phase_as_ice', 'W/m/degK'),
            k_snow=get_constant(
                'thermal_conductivity_of_solid_phase_as_snow', 'W/m/degK'),
            rho_ice=get_constant('density_of_solid_phase_as_ice', 'kg/m^3'),
            c_ice=get_constant(
                'heat_capacity_of_solid_phase_as_ice', 'J/kg/degK'),
            rho_snow=get_constant(
                'density_of_solid_phase_as_snow', 'kg/m^3'),
            c_snow=get_constant(
                'heat_capacity_of_solid_phase_as_snow', 'J/kg/degK'),
            lf=get_constant('latent_heat_of_fusion', 'J/kg'),
            t_melt=get_constant(
                'freezing_temperature_of_liquid_phase', 'degK'),
        )

    @staticmethod
    def _net_flux(raw_state):
        return (np.asarray(raw_state['downwelling_shortwave_flux_in_air'])[:, 0]
                + np.asarray(
                    raw_state['downwelling_longwave_flux_in_air'])[:, 0]
                - np.asarray(
                    raw_state['upwelling_shortwave_flux_in_air'])[:, 0]
                - np.asarray(
                    raw_state['upwelling_longwave_flux_in_air'])[:, 0]
                - np.asarray(raw_state['surface_upward_sensible_heat_flux'])
                - np.asarray(raw_state['surface_upward_latent_heat_flux']))


class SeaIce(_SnowIceBase):
    """1-D thermodynamic sea-ice columns over ``area_type == 'sea_ice'``.

    Basal boundary: prescribed ocean heat flux
    (heat_flux_into_sea_water_due_to_sea_ice), so ice can grow OR melt
    at the base; thickness is clamped non-negative with the excess
    energy routed back into the ocean heat flux.
    """

    input_properties = dict(_FLUX_PROPS_2D, **{
        'surface_upward_latent_heat_flux': {
            'dims': ['*'], 'units': 'W m^-2'},
        'surface_upward_sensible_heat_flux': {
            'dims': ['*'], 'units': 'W m^-2'},
        'sea_ice_thickness': {'dims': ['*'], 'units': 'm'},
        'surface_snow_thickness': {'dims': ['*'], 'units': 'm'},
        'area_type': {'dims': ['*'], 'units': 'dimensionless'},
        'snow_and_ice_temperature': {
            'dims': ['ice_interface_levels', '*'], 'units': 'degK'},
        'sea_surface_temperature': {'dims': ['*'], 'units': 'degK'},
        'heat_flux_into_sea_water_due_to_sea_ice': {
            'dims': ['*'], 'units': 'W m^-2'},
        'height_on_ice_interface_levels': {
            'dims': ['ice_interface_levels', '*'], 'units': 'm'},
    })

    output_properties = {
        'sea_ice_thickness': {'dims': ['*'], 'units': 'm'},
        'surface_snow_thickness': {'dims': ['*'], 'units': 'm'},
        'surface_temperature': {'dims': ['*'], 'units': 'degK'},
        'snow_and_ice_temperature': {
            'dims': ['ice_interface_levels', '*'], 'units': 'degK'},
        'height_on_ice_interface_levels': {
            'dims': ['ice_interface_levels', '*'], 'units': 'm'},
    }

    diagnostic_properties = {
        'heat_flux_into_sea_water_due_to_sea_ice': {
            'dims': ['*'], 'units': 'W m^-2'},
        'surface_downward_heat_flux_in_sea_ice': {
            'dims': ['*'], 'units': 'W m^-2'},
        'surface_albedo_for_direct_shortwave': {
            'dims': ['*'], 'units': 'dimensionless'},
        'surface_albedo_for_diffuse_shortwave': {
            'dims': ['*'], 'units': 'dimensionless'},
    }

    def array_call(self, raw_state, timestep):
        c = self._constants()
        dt = timestep_seconds(timestep)
        net_flux = self._net_flux(raw_state)

        area_type = np.asarray(raw_state['area_type']).astype(str)
        thickness = np.asarray(raw_state['sea_ice_thickness'], float)
        snow = np.asarray(raw_state['surface_snow_thickness'], float)
        temp = np.asarray(raw_state['snow_and_ice_temperature'], float)
        q_ocean = np.asarray(
            raw_state['heat_flux_into_sea_water_due_to_sea_ice'], float)
        total_in = thickness + snow
        owned = area_type == 'sea_ice'
        active = owned & (thickness > 0.0) & (total_in >= _EPSILON)
        if np.any(owned & (thickness > 0.0)
                  & (total_in > self._max_height)):
            raise ValueError(
                'Total height exceeds maximum value of {} m.'.format(
                    self._max_height))

        (new_temp, ice, snow_out, surf_t, heights, q_out, surf_flux, _,
         albedo, neg_energy) = _snow_ice_step(
            jnp.asarray(active), jnp.asarray(temp), jnp.asarray(thickness),
            jnp.asarray(snow), jnp.asarray(net_flux),
            jnp.zeros(active.shape, bool), jnp.asarray(-q_ocean), dt,
            c['rho_ice'], c['rho_snow'], c['c_ice'], c['c_snow'],
            c['k_ice'], c['k_snow'], c['lf'], c['t_melt'],
            self._albedo_snow, self._albedo_ice, self._albedo_melt,
            jnp.ones(active.shape, bool))

        act = jnp.asarray(active)
        outputs = {
            'sea_ice_thickness': jnp.where(act, ice, thickness),
            'surface_snow_thickness': jnp.where(act, snow_out, snow),
            'snow_and_ice_temperature': jnp.where(act[None, :], new_temp,
                                                  temp),
            'surface_temperature': jnp.where(act, surf_t, temp[-1]),
            'height_on_ice_interface_levels': jnp.where(
                act[None, :], heights,
                jnp.asarray(raw_state['height_on_ice_interface_levels'])),
        }
        diagnostics = {
            'heat_flux_into_sea_water_due_to_sea_ice': jnp.where(
                act, q_out, jnp.asarray(q_ocean)),
            'surface_downward_heat_flux_in_sea_ice': jnp.where(
                act, surf_flux, 0.0),
            'surface_albedo_for_direct_shortwave': jnp.where(
                act, albedo, 0.0),
            'surface_albedo_for_diffuse_shortwave': jnp.where(
                act, albedo, 0.0),
        }
        n_neg = int(np.asarray(jnp.sum(neg_energy & act)))
        if n_neg:
            logger.debug('Negative melt energy clamped to 0 on %d '
                         'sea-ice columns.', n_neg)
        return diagnostics, outputs


class LandIce(_SnowIceBase):
    """1-D snow/ice columns over ``area_type in ('land', 'land_ice')``.

    Basal boundary: Dirichlet soil surface temperature; the conducted
    basal exchange is reported as
    ``upward_heat_flux_at_ground_level_in_soil``.
    """

    def __init__(self, maximum_snow_ice_height=10, albedo_snow=0.8,
                 albedo_ice=0.6, albedo_melt=0.2, **kwargs):
        """Bare-ice default albedo is 0.6 over land ice (vs SeaIce's
        0.5), matching the reference's per-component defaults."""
        super().__init__(maximum_snow_ice_height=maximum_snow_ice_height,
                         albedo_snow=albedo_snow, albedo_ice=albedo_ice,
                         albedo_melt=albedo_melt, **kwargs)

    input_properties = dict(_FLUX_PROPS_2D, **{
        'surface_upward_latent_heat_flux': {
            'dims': ['*'], 'units': 'W m^-2'},
        'surface_upward_sensible_heat_flux': {
            'dims': ['*'], 'units': 'W m^-2'},
        'land_ice_thickness': {'dims': ['*'], 'units': 'm'},
        'surface_snow_thickness': {'dims': ['*'], 'units': 'm'},
        'area_type': {'dims': ['*'], 'units': 'dimensionless'},
        'snow_and_ice_temperature': {
            'dims': ['ice_interface_levels', '*'], 'units': 'degK'},
        'soil_surface_temperature': {'dims': ['*'], 'units': 'degK'},
        'height_on_ice_interface_levels': {
            'dims': ['ice_interface_levels', '*'], 'units': 'm'},
    })

    output_properties = {
        'land_ice_thickness': {'dims': ['*'], 'units': 'm'},
        'surface_snow_thickness': {'dims': ['*'], 'units': 'm'},
        'surface_temperature': {'dims': ['*'], 'units': 'degK'},
        'snow_and_ice_temperature': {
            'dims': ['ice_interface_levels', '*'], 'units': 'degK'},
        'height_on_ice_interface_levels': {
            'dims': ['ice_interface_levels', '*'], 'units': 'm'},
    }

    diagnostic_properties = {
        'upward_heat_flux_at_ground_level_in_soil': {
            'dims': ['*'], 'units': 'W m^-2'},
        'surface_albedo_for_direct_shortwave': {
            'dims': ['*'], 'units': 'dimensionless'},
        'surface_albedo_for_diffuse_shortwave': {
            'dims': ['*'], 'units': 'dimensionless'},
    }

    def array_call(self, raw_state, timestep):
        c = self._constants()
        dt = timestep_seconds(timestep)
        net_flux = self._net_flux(raw_state)

        area_type = np.asarray(raw_state['area_type']).astype(str)
        thickness = np.asarray(raw_state['land_ice_thickness'], float)
        snow = np.asarray(raw_state['surface_snow_thickness'], float)
        temp = np.asarray(raw_state['snow_and_ice_temperature'], float)
        soil_t = np.asarray(raw_state['soil_surface_temperature'], float)
        total_in = thickness + snow
        is_land = (area_type == 'land') | (area_type == 'land_ice')
        active = is_land & (total_in >= _EPSILON)
        if np.any(is_land & (total_in > self._max_height)):
            raise ValueError(
                'Total height exceeds maximum value of {} m.'.format(
                    self._max_height))

        (new_temp, ice, snow_out, surf_t, heights, _, _, ground_flux,
         albedo, neg_energy) = _snow_ice_step(
            jnp.asarray(active), jnp.asarray(temp), jnp.asarray(thickness),
            jnp.asarray(snow), jnp.asarray(net_flux),
            jnp.ones(active.shape, bool), jnp.asarray(soil_t), dt,
            c['rho_ice'], c['rho_snow'], c['c_ice'], c['c_snow'],
            c['k_ice'], c['k_snow'], c['lf'], c['t_melt'],
            self._albedo_snow, self._albedo_ice, self._albedo_melt,
            jnp.zeros(active.shape, bool))

        act = jnp.asarray(active)
        outputs = {
            'land_ice_thickness': jnp.where(act, ice, thickness),
            'surface_snow_thickness': jnp.where(act, snow_out, snow),
            'snow_and_ice_temperature': jnp.where(act[None, :], new_temp,
                                                  temp),
            'surface_temperature': jnp.where(act, surf_t, temp[-1]),
            'height_on_ice_interface_levels': jnp.where(
                act[None, :], heights,
                jnp.asarray(raw_state['height_on_ice_interface_levels'])),
        }
        diagnostics = {
            'upward_heat_flux_at_ground_level_in_soil': jnp.where(
                act, ground_flux, 0.0),
            'surface_albedo_for_direct_shortwave': jnp.where(
                act, albedo, 0.0),
            'surface_albedo_for_diffuse_shortwave': jnp.where(
                act, albedo, 0.0),
        }
        n_neg = int(np.asarray(jnp.sum(neg_energy & act)))
        if n_neg:
            logger.debug('Negative melt energy clamped to 0 on %d '
                         'land-ice columns.', n_neg)
        return diagnostics, outputs


class IceSheet(Stepper):
    """Deprecated monolith: a dispatching shim over SeaIce + LandIce.

    Runs both sub-components on the full state and merges per column;
    plain 'sea' columns (owned by neither) pass ``surface_temperature``
    straight through from the input (the three-way merge of the
    reference's surface_ice.py array_call).  Emits a DeprecationWarning
    on construction.
    """

    input_properties = dict(_FLUX_PROPS_2D, **{
        'surface_upward_latent_heat_flux': {
            'dims': ['*'], 'units': 'W m^-2'},
        'surface_upward_sensible_heat_flux': {
            'dims': ['*'], 'units': 'W m^-2'},
        'land_ice_thickness': {'dims': ['*'], 'units': 'm'},
        'sea_ice_thickness': {'dims': ['*'], 'units': 'm'},
        'surface_snow_thickness': {'dims': ['*'], 'units': 'm'},
        'area_type': {'dims': ['*'], 'units': 'dimensionless'},
        'surface_temperature': {'dims': ['*'], 'units': 'degK'},
        'snow_and_ice_temperature': {
            'dims': ['ice_interface_levels', '*'], 'units': 'degK'},
        'sea_surface_temperature': {'dims': ['*'], 'units': 'degK'},
        'soil_surface_temperature': {'dims': ['*'], 'units': 'degK'},
        'height_on_ice_interface_levels': {
            'dims': ['ice_interface_levels', '*'], 'units': 'm'},
        'heat_flux_into_sea_water_due_to_sea_ice': {
            'dims': ['*'], 'units': 'W m^-2'},
    })

    output_properties = {
        'land_ice_thickness': {'dims': ['*'], 'units': 'm'},
        'sea_ice_thickness': {'dims': ['*'], 'units': 'm'},
        'surface_snow_thickness': {'dims': ['*'], 'units': 'm'},
        'surface_temperature': {'dims': ['*'], 'units': 'degK'},
        'snow_and_ice_temperature': {
            'dims': ['ice_interface_levels', '*'], 'units': 'degK'},
        'sea_surface_temperature': {'dims': ['*'], 'units': 'degK'},
        'height_on_ice_interface_levels': {
            'dims': ['ice_interface_levels', '*'], 'units': 'm'},
    }

    diagnostic_properties = {
        'heat_flux_into_sea_water_due_to_sea_ice': {
            'dims': ['*'], 'units': 'W m^-2'},
        'surface_downward_heat_flux_in_sea_ice': {
            'dims': ['*'], 'units': 'W m^-2'},
        'upward_heat_flux_at_ground_level_in_soil': {
            'dims': ['*'], 'units': 'W m^-2'},
        'surface_albedo_for_direct_shortwave': {
            'dims': ['*'], 'units': 'dimensionless'},
        'surface_albedo_for_diffuse_shortwave': {
            'dims': ['*'], 'units': 'dimensionless'},
    }

    def __init__(self, maximum_snow_ice_height=10, **kwargs):
        import warnings
        warnings.warn(
            'IceSheet is deprecated; use SeaIce and LandIce directly.',
            DeprecationWarning, stacklevel=2)
        self._sea = SeaIce(maximum_snow_ice_height=maximum_snow_ice_height)
        self._land = LandIce(
            maximum_snow_ice_height=maximum_snow_ice_height)
        super().__init__(**kwargs)

    def array_call(self, raw_state, timestep):
        sea_diag, sea_out = self._sea.array_call(raw_state, timestep)
        land_diag, land_out = self._land.array_call(raw_state, timestep)

        area_type = np.asarray(raw_state['area_type']).astype(str)
        sea_mask = jnp.asarray(area_type == 'sea_ice')
        land_mask = jnp.asarray(
            (area_type == 'land') | (area_type == 'land_ice'))

        outputs = {}
        outputs['surface_snow_thickness'] = jnp.where(
            sea_mask, sea_out['surface_snow_thickness'],
            land_out['surface_snow_thickness'])
        # three-way surface_temperature merge: un-owned 'sea' cells keep
        # the true input rather than either component's derived proxy
        surf = jnp.asarray(raw_state['surface_temperature'])
        surf = jnp.where(land_mask, land_out['surface_temperature'], surf)
        surf = jnp.where(sea_mask, sea_out['surface_temperature'], surf)
        outputs['surface_temperature'] = surf
        for key in ('snow_and_ice_temperature',
                    'height_on_ice_interface_levels'):
            outputs[key] = jnp.where(sea_mask[None, :], sea_out[key],
                                     land_out[key])
        outputs['sea_ice_thickness'] = sea_out['sea_ice_thickness']
        outputs['land_ice_thickness'] = land_out['land_ice_thickness']
        outputs['sea_surface_temperature'] = jnp.asarray(
            raw_state['sea_surface_temperature'])

        diagnostics = {
            'heat_flux_into_sea_water_due_to_sea_ice':
                sea_diag['heat_flux_into_sea_water_due_to_sea_ice'],
            'surface_downward_heat_flux_in_sea_ice':
                sea_diag['surface_downward_heat_flux_in_sea_ice'],
            'upward_heat_flux_at_ground_level_in_soil':
                land_diag['upward_heat_flux_at_ground_level_in_soil'],
            'surface_albedo_for_direct_shortwave': jnp.where(
                sea_mask, sea_diag['surface_albedo_for_direct_shortwave'],
                land_diag['surface_albedo_for_direct_shortwave']),
            'surface_albedo_for_diffuse_shortwave': jnp.where(
                sea_mask, sea_diag['surface_albedo_for_diffuse_shortwave'],
                land_diag['surface_albedo_for_diffuse_shortwave']),
        }
        return diagnostics, outputs
