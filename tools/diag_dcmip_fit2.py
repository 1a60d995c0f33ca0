"""Correlate the Dcmip divergence residual with each divergence-tendency
term (lap E, lap Phi, momentum-flux divergence, vadv, PGF) on m=0 modes.
CPU: JAX_PLATFORMS=cpu \
    python tools/diag_dcmip_fit2.py
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

import jax.numpy as jnp
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
    ref_raw, units, dims = cache['divergence_of_wind']
    ref = ref_raw.astype('=f8')
    if dims[0] == 'lon':
        ref = np.transpose(ref, (2, 1, 0))

    _, new = dyc(state, timedelta(seconds=10))
    val = new['divergence_of_wind']
    if set(val.dims) == set(dims) and val.dims != tuple(dims):
        val = val.transpose(*dims)
    ours = np.asarray(val.values, 'f8')
    if dims[0] == 'lon':
        ours = np.transpose(ours, (2, 1, 0))

    d = dyc._dycore
    sht = d.sht
    res_tend = np.asarray(sht.analyze((ours - ref) / 10.0))

    def grid3(da, want=('mid_levels', 'lat', 'lon')):
        v = da
        if set(v.dims) == set(want) and v.dims != want:
            v = v.transpose(*want)
        return jnp.asarray(np.asarray(v.values, 'f8'))

    u0 = grid3(state['eastward_wind'])
    v0 = grid3(state['northward_wind'])
    T0 = grid3(state['air_temperature'])
    ps0 = jnp.asarray(np.asarray(
        state['surface_air_pressure'].transpose('lat', 'lon').values,
        'f8'))
    cosl = jnp.sqrt(1.0 - jnp.asarray(sht.mu) ** 2)[None, :, None]
    vort_s, div_s = sht.vort_div_analysis(u0 * cosl, v0 * cosl)
    lnps_s = sht.analyze(jnp.log(ps0))
    T_s = sht.analyze(T0)

    u, v = sht.uv_from_vort_div(vort_s, div_s)
    vort_g = sht.synthesize(vort_s)
    div_g = sht.synthesize(div_s)
    Tv = sht.synthesize(T_s)
    ps = jnp.exp(sht.synthesize(lnps_s))
    dlx, dly = sht.gradient(lnps_s)
    p_half, dp, ln_ratio, alpha = d._vertical_structures(ps)
    rd = d.rd

    v_dot = u * dlx[None] + v * dly[None]
    S = dp * div_g + ps[None] * d.dB[:, None, None] * v_dot
    S_cum = jnp.cumsum(S, axis=0)
    S_total = S_cum[-1]
    mdot = (d.B[1:-1, None, None] * S_total[None] - S_cum[:-1])

    def vadv(X):
        dX = X[1:] - X[:-1]
        flux = mdot * dX
        out = jnp.zeros_like(X)
        out = out.at[:-1].add(flux)
        out = out.at[1:].add(flux)
        return out / (2.0 * dp)

    c_k = (ln_ratio * d.B[:-1, None, None] + alpha
           * d.dB[:, None, None]) * ps[None] / dp
    abs_vort = vort_g + d.f_grid[None]

    def divspec(Nu, Nv):
        _, dd = sht.vort_div_analysis(Nu * cosl, Nv * cosl)
        return np.asarray(dd)

    terms = {
        'vortflux': divspec(abs_vort * v, -abs_vort * u),
        'vadv_mom': divspec(-vadv(u), -vadv(v)),
        'pgf': divspec(-rd * Tv * c_k * dlx[None],
                       -rd * Tv * c_k * dly[None]),
        'lapE': np.asarray(-sht.laplacian(sht.analyze(
            0.5 * (u ** 2 + v ** 2)))),
    }
    rtv_ln = rd * Tv * ln_ratio
    below = jnp.cumsum(rtv_ln[::-1], axis=0)[::-1]
    phi_full = (below - rtv_ln) + rd * Tv * alpha
    terms['lapPhi'] = np.asarray(-sht.laplacian(sht.analyze(phi_full)))
    terms['total'] = sum(terms.values())

    tgt = res_tend[:, 0, 2:9:2].real.ravel()
    print('residual n=2 lev18: {:.3e}; norm {:.3e}'.format(
        res_tend[18, 0, 2].real, np.linalg.norm(tgt)))
    for name, term in terms.items():
        src = term[:, 0, 2:9:2].real.ravel()
        coef = float(np.dot(src, tgt) / np.dot(src, src))
        resid = tgt - coef * src
        r2 = 1.0 - np.dot(resid, resid) / np.dot(tgt, tgt)
        print('{:9s}: value(n=2,l18) {:11.3e}  fit coef {:10.3e}  '
              'R^2 {:8.5f}'.format(name, term[18, 0, 2].real, coef, r2))


if __name__ == '__main__':
    main()
