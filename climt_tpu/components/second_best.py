"""SecondBEST: modular intermediate-complexity BEST land-surface model.

Behavioral parity with
/root/reference/climt/_components/second_best/ (v0.31, Pitman et al.
BEST equations): a thin Stepper orchestrator over five swappable
process objects — SoilProperties, SurfaceAlbedo, SurfaceLayer,
SurfaceFluxes, SubsurfaceTransport — each with a ``Best*`` default,
plus stability-consistent screen-level diagnostics (T/q at 2 m, wind at
10 m) interpolated with the surface layer's own recovered
Monin-Obukhov profile.

Vectorized design: the reference's per-column Python loop becomes
whole-grid vectorized math; the process objects keep the same names and
call contracts but operate on column arrays, and the subsurface
implicit diffusion is one batched tridiagonal solve
(ops/tridiagonal.py) over every land column at once.
"""

from __future__ import annotations

import numpy as np

from ..core.base_components import Stepper, timestep_seconds
from ..core.constants import get_constant
from ..ops.tridiagonal import tridiagonal_solve


class SoilProperties:
    """__call__(soil_type, land_ice_mask) -> dict of per-column params."""

    def __call__(self, soil_type, land_ice_mask):
        raise NotImplementedError


class BestSoilProperties(SoilProperties):
    """BEST Eqs 4.10-4.12 soil parameters by type and area."""

    _COLOUR = {'clay': 0.2, 'sand': 1.0}
    _TEXTURE = {'clay': 0.0, 'sand': 9.0}
    _B = {'clay': 10.0, 'sand': 4.0}
    _K_H0 = {'clay': 0.001, 'sand': 0.1}

    def __call__(self, soil_type, land_ice_mask):
        colour = self._COLOUR[soil_type]
        texture = np.where(land_ice_mask, 0.07, self._TEXTURE[soil_type])
        porosity = 0.6 - 0.03 * texture
        field_capacity = (0.95 - 0.086 * texture) * porosity
        wilting_point = np.where(land_ice_mask, 0.01, porosity - 0.03)
        return {
            'colour': colour, 'texture': texture, 'porosity': porosity,
            'field_capacity': field_capacity,
            'wilting_point': wilting_point,
            'B': self._B[soil_type], 'K_H0': self._K_H0[soil_type],
            'psi_0': -0.2,
        }


class SurfaceAlbedo:
    def __call__(self, soil_props, wetness, land_ice_mask):
        raise NotImplementedError


class BestSurfaceAlbedo(SurfaceAlbedo):
    """BEST Eqs 5.5-5.8."""

    def __call__(self, soil_props, wetness, land_ice_mask):
        ice_sw = 0.60 + 0.06 * (1.0 - wetness)
        soil_sw = (0.10 + 0.1 * soil_props['colour']
                   + 0.06 * (1.0 - wetness))
        alpha_sw = np.where(land_ice_mask, ice_sw, soil_sw)
        alpha_lw = np.where(land_ice_mask, alpha_sw / 3.0, 2.0 * alpha_sw)
        return {'alpha_sw': alpha_sw, 'alpha_lw': alpha_lw}


class SurfaceLayer:
    def __call__(self, z_mid, z0, wind_speed, T_surf, T_air):
        raise NotImplementedError

    def interpolate_to_height(self, drag, z0, z_mid, z_target,
                              surface_value, level_value, kind):
        """Screen-level diagnosis between surface and lowest level with
        the stability profile recovered from the bulk coefficients
        (reduces to the neutral log-law when C_Dm == C_Dh == C_DN)."""
        kappa = get_constant('von_karman_constant', 'dimensionless')
        ln_mid = np.log(z_mid / z0)
        ln_tgt = np.log(z_target / z0)
        frac = z_target / z_mid
        c_dm, c_dh = drag['C_Dm'], drag['C_Dh']
        if kind == 'wind':
            psi_m = ln_mid - kappa / np.sqrt(c_dm)
            weight = np.clip((ln_tgt - psi_m * frac) / (ln_mid - psi_m),
                             0.0, 1.0)
            return level_value * weight
        psi_h = ln_mid - kappa * np.sqrt(c_dm) / c_dh
        weight = np.clip((ln_tgt - psi_h * frac) / (ln_mid - psi_h),
                         0.0, 1.0)
        return surface_value + (level_value - surface_value) * weight


class BestSurfaceLayer(SurfaceLayer):
    """BEST Section 6 stability-dependent bulk drag (land eps=0.01)."""

    def __call__(self, z_mid, z0, wind_speed, T_surf, T_air):
        kappa = get_constant('von_karman_constant', 'dimensionless')
        g = get_constant('gravitational_acceleration', 'm/s^2')
        U = np.maximum(wind_speed, 1e-3)
        c_dn = (kappa / (np.log(z_mid) - np.log(z0))) ** 2
        zeta = np.exp(-kappa / np.sqrt(c_dn))
        ri = -(g * z_mid / (T_surf * U * U)) * (T_surf - T_air)
        eps = 0.01
        unstable = ri < 0.0
        c_dm = np.where(
            unstable,
            c_dn * (1 - 8 * ri
                    / (1 + 56.768 * c_dn * np.sqrt(np.abs(ri) / zeta))),
            c_dn * ((1 - 4 * eps * ri) ** 2) / (1 + 8 * (1 - eps) * ri))
        c_dh = np.where(
            unstable,
            c_dn * (1 - 12 * ri
                    / (1 + 41.801 * c_dn * np.sqrt(np.abs(ri) / zeta))),
            c_dn * ((1 - 4 * eps * ri) / (1 + (6 - 4 * eps) * ri)) ** 2)
        return {'C_Dm': c_dm, 'C_Dh': c_dh, 'C_DN': c_dn, 'Ri': ri}


class SurfaceFluxes:
    def __call__(self, drag, atmos, soil, soil_props, timestep):
        raise NotImplementedError


class BestSurfaceFluxes(SurfaceFluxes):
    """BEST Section 8 bulk fluxes with the beta wetness limiter."""

    def __call__(self, drag, atmos, soil, soil_props, timestep):
        cpd = get_constant(
            'heat_capacity_of_dry_air_at_constant_pressure', 'J/kg/degK')
        lv = get_constant('latent_heat_of_vaporization', 'J/kg')
        lf = get_constant('latent_heat_of_fusion', 'J/kg')
        li = lv + lf
        rho = atmos['air_density']
        U = atmos['wind_speed']
        shf = (rho * cpd * U * drag['C_Dh']
               * (soil['surface_temperature'] - atmos['air_temperature']))

        w_lu, w_fu = soil['W_Lu'], soil['W_Fu']
        c_u = drag['C_Dh'] * U
        dq = (soil['saturation_specific_humidity']
              - atmos['air_specific_humidity'])
        e_pot = rho * c_u * dq
        b = soil_props['B']
        k_h0 = soil_props['K_H0']
        theta = np.clip((w_lu - 0.01) / np.maximum(1.0 - w_fu, 1e-6),
                        1e-3, 1.0)
        rho_w = get_constant('density_of_liquid_water', 'kg/m^3')
        xv = soil_props['porosity']
        psi0 = soil_props['psi_0']
        k_hd = (-4 * k_h0 * b * psi0 * rho_w * xv * (1 - w_fu)) \
            / (np.pi * timestep)
        e_max = k_hd * theta ** (0.5 * b + 2) - k_h0 * theta ** (2 * b + 3)
        frozen_term = (w_fu * lv / li) if li > 0 else 0.0
        ratio = np.where(np.abs(e_pot) > 1e-12,
                         np.clip(e_max / np.where(np.abs(e_pot) > 1e-12,
                                                  e_pot, 1.0), 0.0, 1.0),
                         0.0)
        beta_u = np.clip(frozen_term + ratio, 0.0, 1.0)

        evaporation = beta_u * e_pot / rho
        lhf = lv * rho * evaporation
        momentum = -rho * drag['C_Dm'] * U
        return {'sensible_heat_flux': shf, 'latent_heat_flux': lhf,
                'momentum_flux': momentum, 'evaporation': evaporation,
                'beta': np.clip(beta_u, 0.0, 1.0)}


class SubsurfaceTransport:
    def __call__(self, profiles, surface_flux_bc, timestep, dz):
        raise NotImplementedError


class BestSubsurfaceTransport(SubsurfaceTransport):
    """Implicit heat diffusion + explicit freeze/melt (BEST conduction).

    Batched over columns: profiles are (n_levels, ncol), dz (ncol,).
    Node 0 = bottom, node n-1 = surface; Neumann at both ends with the
    surface flux entering the top row's RHS.
    """

    def __init__(self, thermal_conductivity=2.0,
                 volumetric_heat_capacity=2.0e6):
        self._kappa = thermal_conductivity
        self._cv = volumetric_heat_capacity

    def __call__(self, profiles, surface_flux_bc, timestep, dz):
        import jax.numpy as jnp
        T = jnp.asarray(profiles['T'], float)
        x_w = np.asarray(profiles['X_w'], float)
        x_i = np.asarray(profiles['X_i'], float)
        tf = get_constant('freezing_temperature_of_liquid_phase', 'degK')
        lf = get_constant('latent_heat_of_fusion', 'J/kg')
        rho_w = get_constant('density_of_liquid_water', 'kg/m^3')
        kappa, cv = self._kappa, self._cv
        dt = float(timestep)

        n = T.shape[0]
        rr = kappa * dt / (cv * dz * dz)            # (ncol,)
        rr_full = jnp.broadcast_to(rr, T.shape)
        lower = (-rr_full).at[0].set(0.0)
        upper = (-rr_full).at[-1].set(0.0)
        main = 1.0 + 2.0 * rr_full
        main = main.at[0].add(-rr).at[-1].add(-rr)  # Neumann rows
        rhs = T.at[-1].add(surface_flux_bc * dt / (cv * dz))
        T_diff = np.asarray(tridiagonal_solve(lower, main, upper, rhs))

        gamma = (cv / lf) * (tf - T_diff) / dt
        gamma = np.minimum(np.maximum(gamma, -rho_w * x_i / dt),
                           rho_w * x_w / dt)
        x_i_new = x_i + gamma * dt / rho_w
        x_w_new = x_w - gamma * dt / rho_w
        T_new = T_diff + lf * gamma * dt / cv
        T_new = np.where(np.asarray(surface_flux_bc)[None, :] <= 0,
                         np.minimum(T_new, tf), T_new)
        return {'T': T_new, 'X_w': np.maximum(x_w_new, 0.0),
                'X_i': np.maximum(x_i_new, 0.0)}


def _saturation_specific_humidity(T, p):
    es = 611.2 * np.exp(17.67 * (T - 273.15) / (T - 29.65))
    return 0.622 * es / (p - 0.378 * es)


class SecondBEST(Stepper):
    """Modular BEST land surface model (see module docstring)."""

    input_properties = {
        'air_temperature': {'dims': ['mid_levels', '*'], 'units': 'degK'},
        'specific_humidity': {
            'dims': ['mid_levels', '*'], 'units': 'kg/kg'},
        'northward_wind': {'dims': ['mid_levels', '*'], 'units': 'm s^-1'},
        'eastward_wind': {'dims': ['mid_levels', '*'], 'units': 'm s^-1'},
        'air_pressure': {'dims': ['mid_levels', '*'], 'units': 'Pa'},
        'downwelling_shortwave_flux_in_air': {
            'dims': ['*', 'interface_levels'], 'units': 'W m^-2'},
        'downwelling_longwave_flux_in_air': {
            'dims': ['*', 'interface_levels'], 'units': 'W m^-2'},
        'upwelling_shortwave_flux_in_air': {
            'dims': ['*', 'interface_levels'], 'units': 'W m^-2'},
        'upwelling_longwave_flux_in_air': {
            'dims': ['*', 'interface_levels'], 'units': 'W m^-2'},
        'area_type': {'dims': ['*'], 'units': 'dimensionless'},
        'surface_temperature': {'dims': ['*'], 'units': 'degK'},
        'surface_air_pressure': {'dims': ['*'], 'units': 'Pa'},
        'soil_temperature': {
            'dims': ['soil_interface_levels', '*'], 'units': 'degK'},
        'soil_liquid_water_content': {
            'dims': ['soil_interface_levels', '*'], 'units': 'm^3/m^3'},
        'soil_ice_content': {
            'dims': ['soil_interface_levels', '*'], 'units': 'm^3/m^3'},
        'surface_snow_thickness': {'dims': ['*'], 'units': 'm'},
        'height_on_soil_interface_levels': {
            'dims': ['soil_interface_levels', '*'], 'units': 'm'},
    }

    output_properties = {
        'surface_temperature': {'dims': ['*'], 'units': 'degK'},
        'soil_temperature': {
            'dims': ['soil_interface_levels', '*'], 'units': 'degK'},
        'soil_liquid_water_content': {
            'dims': ['soil_interface_levels', '*'], 'units': 'm^3/m^3'},
        'soil_ice_content': {
            'dims': ['soil_interface_levels', '*'], 'units': 'm^3/m^3'},
        'surface_snow_thickness': {'dims': ['*'], 'units': 'm'},
    }

    diagnostic_properties = {
        'surface_upward_sensible_heat_flux': {
            'dims': ['*'], 'units': 'W m^-2'},
        'surface_upward_latent_heat_flux': {
            'dims': ['*'], 'units': 'W m^-2'},
        'evaporation_rate': {'dims': ['*'], 'units': 'm s^-1'},
        'surface_albedo_for_direct_shortwave': {
            'dims': ['*'], 'units': 'dimensionless'},
        'surface_albedo_for_diffuse_shortwave': {
            'dims': ['*'], 'units': 'dimensionless'},
        'surface_drag_coefficient_for_heat': {
            'dims': ['*'], 'units': 'dimensionless'},
        'surface_drag_coefficient_for_momentum': {
            'dims': ['*'], 'units': 'dimensionless'},
        'air_temperature_at_2m': {'dims': ['*'], 'units': 'degK'},
        'specific_humidity_at_2m': {'dims': ['*'], 'units': 'kg/kg'},
        'eastward_wind_at_10m': {'dims': ['*'], 'units': 'm s^-1'},
        'northward_wind_at_10m': {'dims': ['*'], 'units': 'm s^-1'},
    }

    def __init__(self, soil_type='clay', num_soil_layers=3,
                 minimum_wind_speed=1.0, soil_properties=None, albedo=None,
                 surface_layer=None, fluxes=None, subsurface=None,
                 **kwargs):
        """Pass process instances to override any of the five BEST
        defaults (soil_properties, albedo, surface_layer, fluxes,
        subsurface)."""
        self._soil_type = soil_type
        self._num_soil_layers = num_soil_layers
        self._min_wind = minimum_wind_speed
        self._soil_props = soil_properties or BestSoilProperties()
        self._albedo = albedo or BestSurfaceAlbedo()
        self._surface_layer = surface_layer or BestSurfaceLayer()
        self._fluxes = fluxes or BestSurfaceFluxes()
        self._subsurface = subsurface or BestSubsurfaceTransport()
        super().__init__(**kwargs)

    def array_call(self, state, timestep):
        rd = get_constant('gas_constant_of_dry_air', 'J/kg/degK')
        g = get_constant('gravitational_acceleration', 'm/s^2')
        dt = timestep_seconds(timestep)

        area = np.asarray(state['area_type']).astype(str)
        land = (area == 'land') | (area == 'land_ice')
        land_ice = area == 'land_ice'

        props = self._soil_props(self._soil_type, land_ice)

        u = np.asarray(state['eastward_wind'])[0]
        v = np.asarray(state['northward_wind'])[0]
        wind = np.maximum(np.sqrt(u * u + v * v), self._min_wind)
        T_air = np.asarray(state['air_temperature'])[0]
        p = np.asarray(state['air_pressure'])[0]
        rho = p / (rd * T_air)
        p_surf = np.asarray(state['surface_air_pressure'])
        z_mid = np.maximum((rd * T_air / g) * np.log(p_surf / p), 2.0)
        z0 = np.where(land_ice, 0.001, 0.01)

        T_surf = np.asarray(state['surface_temperature'])
        drag = self._surface_layer(z_mid, z0, wind, T_surf, T_air)

        x_w = np.asarray(state['soil_liquid_water_content'])
        x_i = np.asarray(state['soil_ice_content'])
        w_lu = x_w[-1] / props['porosity']
        albedo = self._albedo(props, w_lu, land_ice)

        q_air = np.asarray(state['specific_humidity'])[0]
        q_sat = _saturation_specific_humidity(T_surf, p)
        atmos = {'air_density': rho, 'wind_speed': wind,
                 'air_temperature': T_air,
                 'air_specific_humidity': q_air, 'u': u, 'v': v}
        soil = {'surface_temperature': T_surf,
                'saturation_specific_humidity': q_sat,
                'W_Lu': w_lu, 'W_Fu': x_i[-1] / props['porosity']}
        flux = self._fluxes(drag, atmos, soil, props, dt)

        net = (np.asarray(state['downwelling_shortwave_flux_in_air'])[:, 0]
               + np.asarray(
                   state['downwelling_longwave_flux_in_air'])[:, 0]
               - np.asarray(
                   state['upwelling_shortwave_flux_in_air'])[:, 0]
               - np.asarray(state['upwelling_longwave_flux_in_air'])[:, 0]
               - flux['sensible_heat_flux'] - flux['latent_heat_flux'])

        z = np.asarray(state['height_on_soil_interface_levels'])
        dz = (np.abs(z[1] - z[0]) if z.shape[0] > 1
              else np.full(area.shape, 0.5))
        new_prof = self._subsurface(
            {'T': np.asarray(state['soil_temperature']),
             'X_w': x_w, 'X_i': x_i},
            surface_flux_bc=net, timestep=dt, dz=dz)

        landl = land[None, :]
        outputs = {
            'soil_temperature': np.where(
                landl, new_prof['T'],
                np.asarray(state['soil_temperature'])),
            'soil_liquid_water_content': np.where(landl, new_prof['X_w'],
                                                  x_w),
            'soil_ice_content': np.where(landl, new_prof['X_i'], x_i),
            'surface_temperature': np.where(land, new_prof['T'][-1],
                                            T_surf),
            'surface_snow_thickness': np.asarray(
                state['surface_snow_thickness']),
        }

        q_surf_eff = (flux['beta'] * q_sat
                      + (1.0 - flux['beta']) * q_air)
        t2m = self._surface_layer.interpolate_to_height(
            drag, z0, z_mid, 2.0, T_surf, T_air, 'scalar')
        q2m = self._surface_layer.interpolate_to_height(
            drag, z0, z_mid, 2.0, q_surf_eff, q_air, 'scalar')
        spd10 = self._surface_layer.interpolate_to_height(
            drag, z0, z_mid, 10.0, 0.0, wind, 'wind')
        spd = np.sqrt(u * u + v * v)
        safe_spd = np.where(spd > 0.0, spd, 1.0)
        u10 = np.where(spd > 0.0, spd10 * u / safe_spd, 0.0)
        v10 = np.where(spd > 0.0, spd10 * v / safe_spd, 0.0)

        def on_land(x):
            return np.where(land, x, 0.0)

        diagnostics = {
            'surface_upward_sensible_heat_flux': on_land(
                flux['sensible_heat_flux']),
            'surface_upward_latent_heat_flux': on_land(
                flux['latent_heat_flux']),
            'evaporation_rate': on_land(flux['evaporation']),
            'surface_albedo_for_direct_shortwave': on_land(
                albedo['alpha_sw']),
            'surface_albedo_for_diffuse_shortwave': on_land(
                albedo['alpha_sw']),
            'surface_drag_coefficient_for_heat': on_land(drag['C_Dh']),
            'surface_drag_coefficient_for_momentum': on_land(
                drag['C_Dm']),
            'air_temperature_at_2m': on_land(t2m),
            'specific_humidity_at_2m': on_land(q2m),
            'eastward_wind_at_10m': on_land(u10),
            'northward_wind_at_10m': on_land(v10),
        }
        return diagnostics, outputs
