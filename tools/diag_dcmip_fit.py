"""Regress the Dcmip divergence residual against candidate discrete
pressure-gradient / geopotential formulation differences.

residual_tend = (ours_onestep - cache)/dt in divergence, m=0 modes.
Each candidate is a difference field (our formula minus a plausible GFS
variant) evaluated on the initial state; a fit coefficient ~1.0 with
high correlation identifies the reference's discrete form.
CPU: JAX_PLATFORMS=cpu \
    python tools/diag_dcmip_fit.py
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
    res_tend = np.asarray(sht.analyze((ours - ref) / 10.0))  # (nz, M, N)

    # ---- rebuild the initial-state ingredients ---------------------------
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
    # band-limited fields (what the dycore actually differentiates)
    u, v = sht.uv_from_vort_div(vort_s, div_s)
    Tv = sht.synthesize(T_s)
    ps = jnp.exp(sht.synthesize(lnps_s))
    dlx, dly = sht.gradient(lnps_s)
    p_half, dp, ln_ratio, alpha = d._vertical_structures(ps)
    B_up = d.B[:-1, None, None]
    B_lo = d.B[1:, None, None]
    dB = d.dB[:, None, None]
    rd = d.rd

    def div_of_pg(c_k):
        """-div(R Tv c_k grad lnps) projected the dycore's way."""
        px = rd * Tv * c_k * dlx[None]
        py = rd * Tv * c_k * dly[None]
        _, dd = sht.vort_div_analysis(-px * cosl, -py * cosl)
        return np.asarray(dd)

    c_ours = (ln_ratio * B_up + alpha * dB) * ps[None] / dp
    base = div_of_pg(c_ours)

    # candidate variants for the PGF coefficient
    alpha_raw = 1.0 - (p_half[:-1] / dp) * jnp.log(
        p_half[1:] / p_half[:-1])          # no ln2 top override
    cands = {
        'alpha_no_ln2_top': (ln_ratio * B_up + alpha_raw * dB)
            * ps[None] / dp,
        'B_lower_iface': (ln_ratio * B_lo - (ln_ratio - alpha) * dB)
            * ps[None] / dp,
        'B_mid': (ln_ratio * 0.5 * (B_up + B_lo)
                  + (alpha - 0.5 * ln_ratio) * dB) * ps[None] / dp,
        'simple_ratio': d.B[1:, None, None] * ps[None]
            / (0.5 * (p_half[1:] + p_half[:-1])),
    }
    # geopotential variant: mid-level p from the (p^(kappa+1)) formula
    rk = d.kappa
    p_full_k = ((p_half[1:] ** (rk + 1) - p_half[:-1] ** (rk + 1))
                / ((rk + 1) * dp)) ** (1.0 / rk)
    alpha_pfull = jnp.log(p_half[1:] / p_full_k)
    cands['phi_alpha_pfull'] = None   # handled below

    print('target: res_tend m=0 n=2 lev18 = {:.3e}'.format(
        res_tend[18, 0, 2].real))
    for name, c_var in cands.items():
        if c_var is None:
            rtv_ln = rd * Tv * ln_ratio
            below = jnp.cumsum(rtv_ln[::-1], axis=0)[::-1]
            phi_a = (below - rtv_ln) + rd * Tv * alpha
            phi_b = (below - rtv_ln) + rd * Tv * alpha_pfull
            diff = np.asarray(
                -sht.laplacian(sht.analyze(phi_a - phi_b)))
        else:
            diff = base - div_of_pg(c_var)
        # projection over m=0 even n, levels 8..27
        tgt = res_tend[:, 0, 2:9:2].real.ravel()
        src = diff[:, 0, 2:9:2].real.ravel()
        denom = float(np.dot(src, src))
        if denom == 0.0:
            print('{:18s}: candidate identically zero'.format(name))
            continue
        coef = float(np.dot(src, tgt)) / denom
        resid = tgt - coef * src
        r2 = 1.0 - np.dot(resid, resid) / max(np.dot(tgt, tgt), 1e-300)
        print('{:18s}: coef {:10.4f}  R^2 {:8.5f}  cand n=2 lev18 '
              '{:10.3e}'.format(name, coef, r2, diff[18, 0, 2].real))


if __name__ == '__main__':
    main()
