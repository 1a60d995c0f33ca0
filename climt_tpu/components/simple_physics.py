"""Reed-Jablonowski (2012) intermediate "simple physics" package.

Behavioral parity with the reference's Fortran implementation
(/root/reference/climt/_lib/simple_physics/simple_physics_custom.f90:60-565,
wrapped at climt/_components/simple_physics/component.py:14-242): three
time-split processes,

1. large-scale condensation (saturation adjustment with latent-heat
   feedback, precipitation as a vertical integral),
2. bulk surface fluxes with the Smith-Vogl (2008) drag law (implicit
   surface momentum drag; explicit sensible/latent heating of the lowest
   layer),
3. partially-implicit Ekman-style boundary-layer diffusion of u, v, theta,
   and q with eddy diffusivities constant below the PBL top and
   Gaussian-tapered above.

Vectorized design: the Fortran's per-column loops become whole-grid
elementwise ops; the implicit PBL tridiagonal solve becomes two
``lax.scan`` sweeps (upward elimination, downward back-substitution) carrying
all columns at once.  Level index 0 is the *lowest* layer (the reference
Fortran is top-down; its Cython wrapper flips, _simple_physics.pyx:102-107).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.base_components import Stepper, timestep_seconds
from ..core.constants import get_constant


def _large_scale_condensation(T, q, p_mid, dp, dt, consts):
    eps, e0, T0 = consts['eps'], 610.78, 273.16
    lv, cp, rd, rv = (consts['lv'], consts['cp'], consts['rd'], consts['rv'])
    qsat = eps * e0 / p_mid * jnp.exp(-lv / rv * (1.0 / T - 1.0 / T0))
    tmp = jnp.where(
        q > qsat,
        (1.0 / dt) * (q - qsat)
        / (1.0 + (lv / cp) * (eps * lv * qsat / (rd * T ** 2))),
        0.0)
    new_T = T + (lv / cp) * tmp * dt
    new_q = q - tmp * dt
    precipitation = jnp.sum(
        tmp * dp / (consts['g'] * consts['rhow']), axis=0)
    return new_T, new_q, precipitation


def _surface_fluxes(T, q, u, v, p_mid, p_int, ps, Ts, qsurf, za, dt,
                    consts, use_qsurf_ext):
    c_heat = consts['C']
    wind = jnp.sqrt(u[0] ** 2 + v[0] ** 2)
    cd = jnp.where(wind < 20.0,
                   consts['Cd0'] + consts['Cd1'] * wind,
                   consts['Cm'])

    # implicit surface momentum drag on the lowest layer
    drag = 1.0 + cd * wind * dt / za
    u = u.at[0].set(u[0] / drag)
    v = v.at[0].set(v[0] / drag)

    dp_low = p_int[0] - p_int[1]

    # sensible heat flux (explicit heating of lowest layer)
    rho = p_mid[0] / (consts['rd'] * T[0])
    t_flux = c_heat * wind * (Ts - T[0])
    sensible = rho * consts['cp'] * t_flux
    T = T.at[0].add(t_flux * (rho * consts['g']) / dp_low * dt)

    # saturation specific humidity at the surface (Buck-style fits with the
    # hard-coded 0.378 = 1 - eps water-vapor factor of the reference)
    es_warm = (1.0007 + 3.46e-8 * ps) * 611.21 * jnp.exp(
        17.966 * (Ts - 273.) / (247.15 + (Ts - 273.)))
    es_cold = (1.0003 + 4.18e-8 * ps) * 611.15 * jnp.exp(
        22.452 * (Ts - 273.) / (272.5 + (Ts - 273.)))
    es = jnp.where(Ts > 271.0, es_warm, es_cold)
    qsats = consts['eps'] * es / (ps - 0.378 * es)
    if use_qsurf_ext:
        qsats = qsurf

    # latent heat flux (with density from the *updated* temperature)
    rho = p_mid[0] / (consts['rd'] * T[0])
    q_flux = c_heat * wind * (qsats - q[0])
    latent = consts['lv'] * rho * q_flux
    q = q.at[0].add(q_flux * (rho * consts['g']) / dp_low * dt)

    return T, q, u, v, sensible, latent, wind, cd


def _pbl_diffusion(T, q, u, v, p_mid, p_int, dp, za, wind, cd, dt, consts):
    """Implicit vertical diffusion via upward elimination + downward
    back-substitution (the Fortran's CE/CF recurrences, f90:479-551)."""
    nz = T.shape[0]
    kappa = consts['rd'] / consts['cp']
    p0 = 1e5

    ke_surf = consts['C'] * wind * za
    km_surf = cd * wind * za

    # interface diffusivities: interfaces j = 1..nz-1 separate layers
    # j-1 (below) and j (above); tapered above the PBL top
    p_i = p_int[1:-1]  # interior interfaces, index j-1 -> interface j
    taper = jnp.where(
        p_i >= consts['pbltop'],
        1.0,
        jnp.exp(-((consts['pbltop'] - p_i) / consts['pblconst']) ** 2))
    km = km_surf[None, :] * taper
    ke = ke_surf[None, :] * taper

    # interface density from the two adjacent layer temperatures
    rho_i = p_i / (consts['rd'] * 0.5 * (T[1:] + T[:-1]))
    g2dt = dt * consts['g'] ** 2
    dpm = p_mid[:-1] - p_mid[1:]  # p_mid[j-1] - p_mid[j] > 0

    # coupling coefficients: layer j down across interface j (CA_down),
    # layer j up across interface j+1 (CC_up)
    ca_m = jnp.zeros_like(T).at[1:].set(g2dt * km * rho_i ** 2
                                        / (dpm * dp[1:]))
    cc_m = jnp.zeros_like(T).at[:-1].set(g2dt * km * rho_i ** 2
                                         / (dpm * dp[:-1]))
    ca_e = jnp.zeros_like(T).at[1:].set(g2dt * ke * rho_i ** 2
                                        / (dpm * dp[1:]))
    cc_e = jnp.zeros_like(T).at[:-1].set(g2dt * ke * rho_i ** 2
                                         / (dpm * dp[:-1]))

    theta = T * (p0 / p_mid) ** kappa

    def up_sweep(carry, inputs):
        e_m_below, e_e_below, fu_b, fv_b, ft_b, fq_b = carry
        ca_m_j, cc_m_j, ca_e_j, cc_e_j, u_j, v_j, th_j, q_j = inputs
        denom_m = 1.0 + ca_m_j + cc_m_j - ca_m_j * e_m_below
        denom_e = 1.0 + ca_e_j + cc_e_j - ca_e_j * e_e_below
        e_m = cc_m_j / denom_m
        e_e = cc_e_j / denom_e
        fu = (u_j + ca_m_j * fu_b) / denom_m
        fv = (v_j + ca_m_j * fv_b) / denom_m
        ft = (th_j + ca_e_j * ft_b) / denom_e
        fq = (q_j + ca_e_j * fq_b) / denom_e
        return (e_m, e_e, fu, fv, ft, fq), (e_m, e_e, fu, fv, ft, fq)

    zero = jnp.zeros_like(wind)
    _, (e_m, e_e, fu, fv, ft, fq) = jax.lax.scan(
        up_sweep, (zero,) * 6,
        (ca_m, cc_m, ca_e, cc_e, u, v, theta, q))

    def down_sweep(carry, inputs):
        u_above, v_above, th_above, q_above = carry
        e_m_j, e_e_j, fu_j, fv_j, ft_j, fq_j = inputs
        u_j = e_m_j * u_above + fu_j
        v_j = e_m_j * v_above + fv_j
        th_j = e_e_j * th_above + ft_j
        q_j = e_e_j * q_above + fq_j
        return (u_j, v_j, th_j, q_j), (u_j, v_j, th_j, q_j)

    _, (u_new, v_new, theta_new, q_new) = jax.lax.scan(
        down_sweep, (zero, zero, zero, zero),
        (e_m, e_e, fu, fv, ft, fq), reverse=True)

    T_new = theta_new * (p_mid / p0) ** kappa
    return T_new, q_new, u_new, v_new


from functools import partial


@partial(jax.jit, static_argnums=(22, 23, 24, 25))
def simple_physics_step(T, q, u, v, p_mid, p_int, ps, Ts, qsurf, dt,
                        g, cp, rd, rv, lv, rhow, pbltop, pblconst,
                        c_heat, cd0, cd1, cm,
                        do_lsc, do_pbl, do_surf_flux, use_qsurf_ext):
    consts = dict(g=g, cp=cp, rd=rd, rv=rv, lv=lv, rhow=rhow,
                  eps=rd / rv, C=c_heat, Cd0=cd0, Cd1=cd1, Cm=cm,
                  pbltop=pbltop, pblconst=pblconst)
    zvir = rv / rd - 1.0

    dp = p_int[:-1] - p_int[1:]  # positive layer thickness
    # hydrostatic height of the lowest mid level
    za = (rd / g) * T[0] * (1.0 + zvir * q[0]) * 0.5 * (
        jnp.log(ps) - jnp.log(p_int[1]))

    precipitation = jnp.zeros_like(ps)
    if do_lsc:
        T, q, precipitation = _large_scale_condensation(
            T, q, p_mid, dp, dt, consts)

    sensible = jnp.zeros_like(ps)
    latent = jnp.zeros_like(ps)
    wind = jnp.sqrt(u[0] ** 2 + v[0] ** 2)
    cd = jnp.where(wind < 20.0, cd0 + cd1 * wind, cm)
    if do_surf_flux:
        T, q, u, v, sensible, latent, wind, cd = _surface_fluxes(
            T, q, u, v, p_mid, p_int, ps, Ts, qsurf, za, dt, consts,
            use_qsurf_ext)

    if do_pbl:
        T, q, u, v = _pbl_diffusion(
            T, q, u, v, p_mid, p_int, dp, za, wind, cd, dt, consts)

    return T, q, u, v, precipitation, sensible, latent


class SimplePhysics(Stepper):
    """Reed & Jablonowski (2012) surface fluxes + boundary layer + LSC."""

    input_properties = {
        'air_temperature': {'dims': ['mid_levels', '*'], 'units': 'degK'},
        'air_pressure': {'dims': ['mid_levels', '*'], 'units': 'Pa'},
        'air_pressure_on_interface_levels': {
            'dims': ['interface_levels', '*'], 'units': 'Pa'},
        'surface_air_pressure': {'dims': ['*'], 'units': 'Pa'},
        'surface_temperature': {'dims': ['*'], 'units': 'degK'},
        'specific_humidity': {'dims': ['mid_levels', '*'], 'units': 'kg/kg'},
        'northward_wind': {'dims': ['mid_levels', '*'], 'units': 'm s^-1'},
        'eastward_wind': {'dims': ['mid_levels', '*'], 'units': 'm s^-1'},
        'surface_specific_humidity': {'dims': ['*'], 'units': 'kg/kg'},
        'latitude': {'dims': ['*'], 'units': 'degrees_north'},
    }

    diagnostic_properties = {
        'stratiform_precipitation_rate': {'dims': ['*'], 'units': 'm s^-1'},
        'surface_upward_latent_heat_flux': {'dims': ['*'],
                                            'units': 'W m^-2'},
        'surface_upward_sensible_heat_flux': {'dims': ['*'],
                                              'units': 'W m^-2'},
    }

    output_properties = {
        'air_temperature': {'units': 'degK'},
        'specific_humidity': {'units': 'kg/kg'},
        'northward_wind': {'units': 'm s^-1'},
        'eastward_wind': {'units': 'm s^-1'},
    }

    def __init__(self, simulate_cyclone=False, large_scale_condensation=True,
                 boundary_layer=True, surface_fluxes=True,
                 use_external_surface_temperature=True,
                 use_external_surface_specific_humidity=False,
                 top_of_boundary_layer=85000.0,
                 boundary_layer_influence_height=20000.0,
                 drag_coefficient_heat_fluxes=0.0011,
                 base_momentum_drag_coefficient=0.0007,
                 wind_dependent_momentum_drag_coefficient=0.000065,
                 maximum_momentum_drag_coefficient=0.002,
                 **kwargs):
        self._cyclone = simulate_cyclone
        self._lsc = large_scale_condensation
        self._pbl = boundary_layer
        self._surface_flux = surface_fluxes
        self._use_ext_ts = use_external_surface_temperature
        self._use_ext_qsurf = use_external_surface_specific_humidity
        self._Ct = drag_coefficient_heat_fluxes
        self._pbl_top = top_of_boundary_layer
        self._delta_pbl = boundary_layer_influence_height
        self._Cd0 = base_momentum_drag_coefficient
        self._Cd1 = wind_dependent_momentum_drag_coefficient
        self._Cm = maximum_momentum_drag_coefficient
        super().__init__(**kwargs)

    def _surface_temperature(self, raw_state, consts):
        """Tsurf selection, reproducing the reference's flag semantics
        (simple_physics_custom.f90:280-298)."""
        if self._use_ext_ts:
            return jnp.asarray(raw_state['surface_temperature'])
        lat = jnp.deg2rad(jnp.asarray(raw_state['latitude']))
        if self._cyclone:
            # latitude-dependent SST of the moist baroclinic-wave test 4-3
            rd, a, omega = consts
            zvir = (461.5 / rd) - 1.0
            u0, T00 = 35.0, 288.0
            latw = 2.0 * jnp.pi / 9.0
            eta0 = 0.252
            etav = (1 - eta0) * 0.5 * jnp.pi
            q0 = 0.021
            return (T00 + jnp.pi * u0 / rd * 1.5 * jnp.sin(etav)
                    * jnp.cos(etav) ** 0.5 *
                    ((-2. * jnp.sin(lat) ** 6
                      * (jnp.cos(lat) ** 2 + 1. / 3.) + 10. / 63.)
                     * u0 * jnp.cos(etav) ** 1.5
                     + (8. / 5. * jnp.cos(lat) ** 3
                        * (jnp.sin(lat) ** 2 + 2. / 3.)
                        - jnp.pi / 4.) * a * omega * 0.5)) / (
                1. + zvir * q0 * jnp.exp(-(lat / latw) ** 4))
        return jnp.full_like(lat, 302.15)  # constant tropical-cyclone SST

    def array_call(self, raw_state, timestep):
        dt = timestep_seconds(timestep)
        g = get_constant('gravitational_acceleration', 'm/s^2')
        cp = get_constant(
            'heat_capacity_of_dry_air_at_constant_pressure', 'J/kg/degK')
        rd = get_constant('gas_constant_of_dry_air', 'J/kg/degK')
        rv = get_constant('gas_constant_of_vapor_phase', 'J/kg/degK')
        lv = get_constant('latent_heat_of_condensation', 'J/kg')
        rhow = get_constant('density_of_liquid_water', 'kg/m^3')
        a = get_constant('planetary_radius', 'm')
        omega = get_constant('planetary_rotation_rate', 's^-1')

        Ts = self._surface_temperature(raw_state, (rd, a, omega))
        T, q, u, v, precipitation, sensible, latent = simple_physics_step(
            jnp.asarray(raw_state['air_temperature']),
            jnp.asarray(raw_state['specific_humidity']),
            jnp.asarray(raw_state['eastward_wind']),
            jnp.asarray(raw_state['northward_wind']),
            jnp.asarray(raw_state['air_pressure']),
            jnp.asarray(raw_state['air_pressure_on_interface_levels']),
            jnp.asarray(raw_state['surface_air_pressure']),
            Ts,
            jnp.asarray(raw_state['surface_specific_humidity']),
            dt, g, cp, rd, rv, lv, rhow,
            self._pbl_top, self._delta_pbl,
            self._Ct, self._Cd0, self._Cd1, self._Cm,
            self._lsc, self._pbl, self._surface_flux, self._use_ext_qsurf)
        latent = jnp.maximum(latent, 0.0)
        diagnostics = {
            'stratiform_precipitation_rate': precipitation,
            'surface_upward_sensible_heat_flux': sensible,
            'surface_upward_latent_heat_flux': latent,
        }
        new_state = {
            'eastward_wind': u,
            'northward_wind': v,
            'air_temperature': T,
            'specific_humidity': q,
        }
        return diagnostics, new_state
