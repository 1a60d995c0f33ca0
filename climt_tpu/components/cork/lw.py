"""CorkLongwaveRadiation: CORK correlated-k / picket-fence LW radiation.

Reference: /root/reference/climt/_components/cork/lw/{component,kernels}.py
(v0.31).  Two optics modes: 'correlated_k' (table-driven, per-band
g-point quadrature, optional H2O/CO2 runtime axes and decoupled H2O
continuum) and 'parmentier' (two-band picket-fence with Freedman
Rosseland means).  The transport is the two-stream diffusivity
approximation trans = exp(-D tau) with a configurable D
(``diffusivity_factor``; Elsasser 1.66 default, the EC2213 notes use 2).

Vectorized design: the reference's per-column numba sweeps become two
``lax.scan``s over levels carrying the full (nband, ngpt, ncol)
radiance block; per-band and broadband fluxes accumulate as weighted
g-sums inside the scan.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ...core.base_components import TendencyComponent
from ...core.constants import get_constant
from .common import (MOLAR_MASS, MOLAR_MASS_DRY_AIR, bracket,
                     compute_column_amount, compute_heating_rate)

DIFFUSIVITY_FACTOR = 1.66


def planck_sources(planck_frac, T_grid, T, T_surf, sigma, nband, ngpt,
                   is_esft):
    """Planck layer and surface sources per (band, g-point).

    planck_frac: (nband_orig, ngpt_orig, nT); T (nlev, ncol);
    T_surf (ncol,).  Returns planck_src (nband, ngpt, nlev, ncol),
    surf_src (nband, ngpt, ncol).  Linear-in-T interpolation of the
    fraction times sigma T^4, with the reference's bracket clamps and
    band/g index mapping for ESFT-expanded g-points.
    """
    nband_orig, ngpt_orig, _ = planck_frac.shape
    ib = np.minimum(np.arange(nband), nband_orig - 1)
    ig = (np.arange(ngpt) % ngpt_orig) if is_esft else np.arange(ngpt)
    pf = jnp.asarray(planck_frac)[ib][:, ig]       # (nband, ngpt, nT)

    def interp(temps):
        iT, fT = bracket(T_grid, temps.reshape(-1))
        frac = (pf[:, :, iT] * (1.0 - fT) + pf[:, :, iT + 1] * fT)
        planck = sigma * temps.reshape(-1) ** 4
        return (frac * planck[None, None, :]).reshape(
            (nband, ngpt) + temps.shape)

    return interp(T), interp(T_surf)


@functools.partial(jax.jit, static_argnames=('want_diag',))
def lw_transport(tau, planck_src, surf_src, emissivity, weights,
                 diffusivity_factor, want_diag=False):
    """Two-stream diffusivity LW transport over all (band, g, column).

    tau/planck_src (nband, ngpt, nlev, ncol); surf_src
    (nband, ngpt, ncol); emissivity (nband, ncol); weights (nband,
    ngpt).  Returns (up_band, down_band, up_broad, down_broad
    [, diag]): per-band interface fluxes (nband, nlev+1, ncol) and
    broadband sums.
    """
    nband, ngpt, nlev, ncol = tau.shape
    w = weights[:, :, None]

    trans_levels = jnp.exp(
        -diffusivity_factor * jnp.moveaxis(tau, 2, 0))   # (nlev, b, g, c)
    src_levels = jnp.moveaxis(planck_src, 2, 0)

    def up_step(up_prev, xs):
        trans, src = xs
        up_cur = up_prev * trans + src * (1.0 - trans)
        return up_cur, (jnp.sum(w * up_cur, axis=1), up_cur)

    up0 = emissivity[:, None, :] * surf_src
    _, (up_sums, up_g) = jax.lax.scan(up_step, up0,
                                      (trans_levels, src_levels))
    up_band = jnp.concatenate(
        [jnp.sum(w * up0, axis=1)[None], up_sums], axis=0)
    up_band = jnp.moveaxis(up_band, 0, 1)            # (nband, nlev+1, ncol)

    def dn_step(dn_prev, xs):
        trans, src = xs
        dn_cur = dn_prev * trans + src * (1.0 - trans)
        return dn_cur, (jnp.sum(w * dn_cur, axis=1), dn_cur)

    zero = jnp.zeros((nband, ngpt, ncol), tau.dtype)
    _, (dn_sums, dn_g) = jax.lax.scan(
        dn_step, zero, (trans_levels[::-1], src_levels[::-1]))
    down_band = jnp.concatenate(
        [dn_sums[::-1], jnp.zeros((1, nband, ncol), tau.dtype)], axis=0)
    down_band = jnp.moveaxis(down_band, 0, 1)

    up_broad = jnp.sum(up_band, axis=0)
    down_broad = jnp.sum(down_band, axis=0)
    if not want_diag:
        return up_band, down_band, up_broad, down_broad, None
    diag = {
        'transmittance': jnp.moveaxis(trans_levels, 0, 2),
        'up_per_gpoint': jnp.moveaxis(jnp.concatenate(
            [(w * up0)[None], w[None] * up_g], axis=0), 0, 2),
        'down_per_gpoint': jnp.moveaxis(jnp.concatenate(
            [(w[None] * dn_g)[::-1],
             jnp.zeros((1, nband, ngpt, ncol), tau.dtype)], axis=0), 0, 2),
    }
    return up_band, down_band, up_broad, down_broad, diag


class CorkLongwaveRadiation(TendencyComponent):
    """CORK longwave radiation with per-band diagnostics."""

    _diffusivity_factor = DIFFUSIVITY_FACTOR

    def __init__(self, optics='correlated_k', table=None,
                 coefficients='solar_composition',
                 rosseland_mean_fit='freedman2014',
                 diffusivity_factor=DIFFUSIVITY_FACTOR, **kwargs):
        """optics='correlated_k' runs a shipped or user k-table (see
        ck_tables.load_k_table); optics='parmentier' runs the two-band
        picket-fence scheme.  diffusivity_factor sets D in
        trans = exp(-D tau)."""
        from .ck_tables import load_k_table
        self._diffusivity_factor = diffusivity_factor
        self._optics_mode = optics
        self._has_co2_axis = False
        if optics == 'parmentier':
            from .parmentier import (load_freedman2014_coefficients,
                                     load_parmentier_coefficients)
            self._coefficients = load_parmentier_coefficients(coefficients)
            self._freedman_coeffs = load_freedman2014_coefficients()
            self._num_bands = 2
        elif optics == 'correlated_k':
            self._table = load_k_table(table)
            self._num_bands = self._table['k_coefficients'].shape[1]
            self._num_gpts = self._table['k_coefficients'].shape[2]
            self._gas_names = [str(g) for g in
                               np.atleast_1d(self._table['gas_names'])]
            has_h2o_axis = 'h2o_vmr_grid' in self._table
            self._has_co2_axis = 'co2_vmr_grid' in self._table
            self._fully_premixed = (self._gas_names == ['effective']
                                    and not has_h2o_axis)
            self._premixed_bg = (
                (self._gas_names == ['effective'] and has_h2o_axis)
                or str(self._table.get('background_is_premixed',
                                       np.array(''))).lower() == 'true')
        else:
            raise ValueError('Unknown optics mode: {}'.format(optics))
        self._diagnostics_level = kwargs.pop('diagnostics_level', 0)
        from ...core.initialization import set_num_longwave_bands
        set_num_longwave_bands(self._num_bands)
        super().__init__(**kwargs)

    @property
    def input_properties(self):
        props = {
            'air_temperature': {'dims': ['mid_levels', '*'],
                                'units': 'degK', 'alias': 'T'},
            'air_pressure': {'dims': ['mid_levels', '*'], 'units': 'Pa',
                             'alias': 'p'},
            'air_pressure_on_interface_levels': {
                'dims': ['interface_levels', '*'], 'units': 'Pa',
                'alias': 'p_int'},
            'surface_temperature': {'dims': ['*'], 'units': 'degK',
                                    'alias': 'T_surf'},
            'surface_longwave_emissivity': {
                'dims': ['num_longwave_bands', '*'],
                'units': 'dimensionless', 'alias': 'emissivity'},
        }
        if self._optics_mode == 'parmentier':
            props['irradiation_temperature'] = {
                'dims': ['*'], 'units': 'degK', 'alias': 'T_irr'}
            props['internal_temperature'] = {
                'dims': ['*'], 'units': 'degK', 'alias': 'T_int'}
        elif self._optics_mode == 'correlated_k':
            if self._premixed_bg:
                props['specific_humidity'] = {
                    'dims': ['mid_levels', '*'], 'units': 'kg/kg',
                    'alias': 'h2o'}
                if self._has_co2_axis:
                    props['mole_fraction_of_carbon_dioxide_in_air'] = {
                        'dims': ['mid_levels', '*'], 'units': 'mole/mole',
                        'alias': 'co2'}
            elif not self._fully_premixed:
                gas_cf = {'h2o': 'specific_humidity',
                          'co2': 'mole_fraction_of_carbon_dioxide_in_air'}
                gas_units = {'h2o': 'kg/kg'}
                for gas in self._gas_names:
                    cf = gas_cf.get(gas,
                                    'mole_fraction_of_{}_in_air'.format(gas))
                    props[cf] = {'dims': ['mid_levels', '*'],
                                 'units': gas_units.get(gas, 'mole/mole'),
                                 'alias': gas}
        props['longwave_optical_thickness_due_to_cloud'] = {
            'dims': ['mid_levels', '*', 'num_longwave_bands'],
            'units': 'dimensionless', 'alias': 'tau_cloud_lw'}
        return props

    @property
    def tendency_properties(self):
        return {'air_temperature': {'units': 'degK s^-1'}}

    @property
    def diagnostic_properties(self):
        props = {
            'upwelling_longwave_flux_in_air': {
                'dims': ['interface_levels', '*'], 'units': 'W m^-2'},
            'downwelling_longwave_flux_in_air': {
                'dims': ['interface_levels', '*'], 'units': 'W m^-2'},
            'upwelling_longwave_flux_in_air_per_band': {
                'dims': ['interface_levels', '*', 'num_longwave_bands'],
                'units': 'W m^-2'},
            'downwelling_longwave_flux_in_air_per_band': {
                'dims': ['interface_levels', '*', 'num_longwave_bands'],
                'units': 'W m^-2'},
            'air_temperature_tendency_from_longwave': {
                'dims': ['mid_levels', '*'], 'units': 'degK day^-1'},
            'longwave_optical_depth_per_band': {
                'dims': ['mid_levels', '*', 'num_longwave_bands'],
                'units': 'dimensionless'},
            'longwave_transmittance_per_band': {
                'dims': ['mid_levels', '*', 'num_longwave_bands'],
                'units': 'dimensionless'},
            'air_temperature_tendency_from_longwave_per_band': {
                'dims': ['mid_levels', '*', 'num_longwave_bands'],
                'units': 'degK day^-1'},
        }
        if self._diagnostics_level >= 1:
            props['lw_layer_transmittance'] = {
                'dims': ['mid_levels', '*', 'num_longwave_bands'],
                'units': 'dimensionless'}
            props['lw_up_per_gpoint'] = {
                'dims': ['interface_levels', '*', 'num_longwave_bands'],
                'units': 'W m^-2'}
            props['lw_down_per_gpoint'] = {
                'dims': ['interface_levels', '*', 'num_longwave_bands'],
                'units': 'W m^-2'}
        return props

    @property
    def num_longwave_bands(self):
        return self._num_bands

    def array_call(self, state):
        T = jnp.asarray(state['T'])
        p = jnp.asarray(state['p'])
        p_int = jnp.asarray(state['p_int'])
        T_surf = jnp.asarray(state['T_surf'])
        nlev, ncol = T.shape

        sigma = get_constant('stefan_boltzmann_constant', 'W/m^2/K^4')
        g = get_constant('gravitational_acceleration', 'm/s^2')
        cpd = get_constant(
            'heat_capacity_of_dry_air_at_constant_pressure', 'J/kg/K')

        if self._optics_mode == 'parmentier':
            tau, planck_src, surf_src = self._parmentier_optics(
                T, p, p_int, T_surf, jnp.asarray(state['T_irr']),
                jnp.asarray(state['T_int']), sigma, g)
            weights = jnp.ones(tau.shape[:2])
        else:
            tau, planck_src, surf_src, weights = self._ck_optics(
                state, T, p, p_int, T_surf, sigma, g)

        nband, ngpt = tau.shape[:2]
        emissivity = jnp.asarray(state['emissivity'])
        tau_cloud = jnp.asarray(state['tau_cloud_lw'])   # (nlev, ncol, nb)
        tau = tau + jnp.moveaxis(tau_cloud, -1, 0)[:, None, :, :]

        want_diag = self._diagnostics_level > 0
        up_band, down_band, up_broad, down_broad, kdiag = lw_transport(
            tau, planck_src, surf_src, emissivity, jnp.asarray(weights),
            self._diffusivity_factor, want_diag=want_diag)

        net = up_broad - down_broad
        heating = compute_heating_rate(net, p_int, g, cpd)

        D = self._diffusivity_factor
        w = jnp.asarray(weights)
        tau_band = jnp.einsum('bglc,bg->blc', tau, w)
        hr_band = jax.vmap(
            lambda u, d: compute_heating_rate(u - d, p_int, g, cpd)
        )(up_band, down_band) * 86400.0

        def band_last(x):                       # (nband, ..., ncol)
            return jnp.moveaxis(x, 0, -1)

        diagnostics = {
            'upwelling_longwave_flux_in_air': up_broad,
            'downwelling_longwave_flux_in_air': down_broad,
            'upwelling_longwave_flux_in_air_per_band': band_last(up_band),
            'downwelling_longwave_flux_in_air_per_band':
                band_last(down_band),
            'air_temperature_tendency_from_longwave': heating * 86400.0,
            'longwave_optical_depth_per_band': band_last(tau_band),
            'longwave_transmittance_per_band': band_last(
                jnp.exp(-D * tau_band)),
            'air_temperature_tendency_from_longwave_per_band':
                band_last(hr_band),
        }
        if want_diag:
            w_sum = w.sum(axis=1)

            def avg(x):                          # (nband, ngpt, ..., ncol)
                return band_last(jnp.einsum('bg...,bg->b...', x, w)
                                 / w_sum[(slice(None),)
                                         + (None,) * (x.ndim - 2)])

            diagnostics['lw_layer_transmittance'] = avg(
                kdiag['transmittance'])
            diagnostics['lw_up_per_gpoint'] = avg(kdiag['up_per_gpoint'])
            diagnostics['lw_down_per_gpoint'] = avg(
                kdiag['down_per_gpoint'])
        return ({'T': heating}, diagnostics)

    def _ck_optics(self, state, T, p, p_int, T_surf, sigma, g):
        from .ck_tables import compute_ck_optical_depth
        nlev, ncol = T.shape
        ngas = len(self._gas_names)
        h2o_vmr = co2_vmr = None
        if self._fully_premixed:
            gas_amounts = compute_column_amount(
                jnp.ones((nlev, ncol)), p_int, g)[None]
        elif self._premixed_bg:
            q = jnp.asarray(state['h2o'])
            gas_amounts = compute_column_amount(
                jnp.ones_like(q), p_int, g)[None]
            m_ratio = MOLAR_MASS['h2o'] / MOLAR_MASS_DRY_AIR
            h2o_vmr = q / jnp.maximum(q + (1.0 - q) * m_ratio, 1e-30)
            if self._has_co2_axis:
                co2_vmr = jnp.asarray(state['co2'])
        else:
            amounts = []
            for gas in self._gas_names:
                q = jnp.asarray(state[gas])
                if gas != 'h2o':
                    q = q * (MOLAR_MASS.get(gas, MOLAR_MASS_DRY_AIR)
                             / MOLAR_MASS_DRY_AIR)
                amounts.append(compute_column_amount(q, p_int, g))
            gas_amounts = jnp.stack(amounts)

        result = compute_ck_optical_depth(
            self._table, T, p, gas_amounts, h2o_vmr=h2o_vmr,
            co2_vmr=co2_vmr)
        if isinstance(result, tuple):
            tau, weights = result
        else:
            tau = result
            weights = self._table['gpoint_weights']
        nband, ngpt = tau.shape[:2]
        overlap = str(self._table.get('overlap_method',
                                      np.array('additive')))
        is_esft = (overlap == 'esft' and ngas > 1)
        planck_src, surf_src = planck_sources(
            np.asarray(self._table['planck_fraction'], float),
            jnp.asarray(np.asarray(self._table['temperature_grid'],
                                   float)),
            T, T_surf, sigma, nband, ngpt, is_esft)
        return tau, planck_src, surf_src, weights

    def _parmentier_optics(self, T, p, p_int, T_surf, T_irr, T_int,
                           sigma, g):
        from .parmentier import (compute_rosseland_mean_opacity,
                                 compute_thermal_opacities,
                                 lookup_ratio_coefficients)
        nlev, ncol = T.shape
        # T_eff per column (Lee et al. 2021 Eq. 20; A_B=0, mu*=1/4)
        T_eff = np.maximum(
            (np.asarray(T_int) ** 4
             + 0.25 * np.asarray(T_irr) ** 4) ** 0.25, 100.0)
        gv1, gv2, gv3, beta, gamma_P, R = lookup_ratio_coefficients(
            self._coefficients, T_eff)
        kappa_R = compute_rosseland_mean_opacity(
            np.asarray(T), np.asarray(p), self._freedman_coeffs)
        kappa_1, kappa_2 = compute_thermal_opacities(
            kappa_R, gamma_P[None, :], beta[None, :], R[None, :])
        mass = np.abs(np.asarray(p_int)[1:] - np.asarray(p_int)[:-1]) / g
        tau = jnp.asarray(np.stack([kappa_1 * mass, kappa_2 * mass])
                          [:, None, :, :])
        planck = sigma * np.asarray(T) ** 4
        planck_src = jnp.asarray(np.stack(
            [beta[None, :] * planck,
             (1.0 - beta)[None, :] * planck])[:, None, :, :])
        surf_planck = sigma * np.asarray(T_surf) ** 4
        surf_src = jnp.asarray(np.stack(
            [beta * surf_planck, (1.0 - beta) * surf_planck])[:, None, :])
        return tau, planck_src, surf_src
