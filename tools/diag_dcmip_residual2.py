"""Fit the Dcmip divergence residual against candidate source terms.

Computes the m=0 spectral coefficients of (a) the initial-state
divergence, (b) the one-step divergence change, (c) the ours-minus-cache
residual, per n and level, and prints their ratios.  A constant ratio
against (a) identifies a multiplicative operator difference on the
initial divergence; n-dependence like (n(n+1))^p identifies a del^2p
term.  CPU: JAX_PLATFORMS=cpu \
    python tools/diag_dcmip_residual2.py
"""

import os
import sys
from datetime import timedelta

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'tests'))

import jax
jax.config.update('jax_enable_x64', True)

import numpy as np

import climt_tpu as ct
from climt_tpu import GFSDynamicalCore
from golden import CACHE_DIR, load_cache


def main():
    dyc = GFSDynamicalCore([])
    state = ct.get_default_state(
        [dyc], grid_state=ct.get_grid(nx=32, ny=32, nz=28))
    dcmip = ct.DcmipInitialConditions(add_perturbation=True)
    out = dcmip(state)
    for k, v in out.items():
        if k in state and k not in (
                'surface_air_pressure', 'air_pressure',
                'air_pressure_on_interface_levels'):
            state[k] = v

    cache = load_cache(
        '{}/TestGFSDycoreWithDcmipInitialConditions-3d-1.cache'.format(
            CACHE_DIR))

    _, new = dyc(state, timedelta(seconds=10))

    sht = dyc._dycore.sht

    def grid3(da):
        v = da
        if set(v.dims) == {'mid_levels', 'lat', 'lon'} and v.dims != (
                'mid_levels', 'lat', 'lon'):
            v = v.transpose('mid_levels', 'lat', 'lon')
        return np.asarray(v.values, 'f8')

    u0 = grid3(state['eastward_wind'])
    v0 = grid3(state['northward_wind'])
    cosl = np.sqrt(1.0 - np.asarray(sht.mu) ** 2)[None, :, None]
    _, div0_spec = sht.vort_div_analysis(u0 * cosl, v0 * cosl)
    div0_grid = np.asarray(sht.synthesize(div0_spec))

    def spec_m0(grid3):
        return np.asarray(sht.analyze(np.asarray(grid3, 'f8')))[:, 0, :]

    ref_raw, units, dims = cache['divergence_of_wind']
    val = new['divergence_of_wind']
    if set(val.dims) == set(dims) and val.dims != tuple(dims):
        val = val.transpose(*dims)
    ours = np.asarray(val.values, 'f8')
    ref = ref_raw.astype('=f8')
    if dims[0] == 'lon':                  # normalize to (z, lat, lon)
        ours = np.transpose(ours, (2, 1, 0))
        ref = np.transpose(ref, (2, 1, 0))

    s_init = spec_m0(div0_grid)           # (nz, N)
    s_res = spec_m0(ours - ref)
    s_step = spec_m0(ours - div0_grid)
    s_ref_step = spec_m0(ref - div0_grid)

    lev = 18
    print('level', lev)
    print('n     init_div       step(ours)     step(ref)      residual'
          '       res/init       res/step')
    for n in range(0, 12):
        i0 = s_init[lev, n]
        st = s_step[lev, n]
        sr = s_ref_step[lev, n]
        r = s_res[lev, n]
        print('{:2d}  {:13.4e}  {:13.4e}  {:13.4e}  {:13.4e}  '
              '{:13.4e}  {:13.4e}'.format(
                  n, i0.real, st.real, sr.real, r.real,
                  (r / i0).real if abs(i0) > 0 else float('nan'),
                  (r / st).real if abs(st) > 0 else float('nan')))

    # and by level at n=2
    print('\nn=2 by level: residual / init_div')
    for lev in range(0, 28, 3):
        i0, r = s_init[lev, 2], s_res[lev, 2]
        print('{:2d}  init {:11.3e}  res {:11.3e}  ratio {:11.3e}'.format(
            lev, i0.real, r.real,
            (r / i0).real if abs(i0) > 0 else float('nan')))


if __name__ == '__main__':
    main()
