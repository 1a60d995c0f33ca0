"""Test: does truncating the u,v synthesis at n=T (dropping the exact
P_{T+1} contribution of the meridional derivative) reproduce the
reference's Dcmip divergence?  CPU:
JAX_PLATFORMS=cpu \
    python tools/diag_dcmip_trunc_uv.py
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
from climt_tpu.ops import sht as sht_mod
from golden import CACHE_DIR, load_cache


def _eps(n, m):
    if n < abs(m):
        return 0.0
    return np.sqrt((n * n - m * m) / (4.0 * n * n - 1.0))


def run(truncate_uv):
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

    # force dycore construction BEFORE the first call so the basis patch
    # is in place when the (unjitted) initial_step traces
    nz = 28
    ak = np.asarray(state[
        'atmosphere_hybrid_sigma_pressure_a_coordinate_on_interface_'
        'levels'].values)
    bk = np.asarray(state[
        'atmosphere_hybrid_sigma_pressure_b_coordinate_on_interface_'
        'levels'].values)
    dyc._ensure_dycore(32, 32, nz, ak, bk, 10.0)

    if truncate_uv:
        sht = dyc._dycore.sht
        T = sht.truncation
        mu = np.asarray(sht.mu)
        P_full, H_full = sht_mod._legendre_tensors(T, mu)
        H_tr = np.asarray(H_full).copy()
        for m in range(0, T + 1):
            n = T
            if n < m:
                continue
            term = np.zeros_like(mu)
            if n - 1 >= m:
                term = (n + 1.0) * _eps(n, m) * P_full[m, n - 1]
            H_tr[m, n] = term
        sht.H = jnp.asarray(H_tr, dtype=sht.dtype)

    _, new = dyc(state, timedelta(seconds=10))
    return new


def main():
    cache = load_cache(
        '{}/TestGFSDycoreWithDcmipInitialConditions-3d-1.cache'.format(
            CACHE_DIR))

    for flag in (False, True):
        new = run(flag)
        print('--- truncate_uv =', flag)
        for name in ('northward_wind', 'eastward_wind',
                     'air_temperature', 'divergence_of_wind',
                     'atmosphere_relative_vorticity',
                     'surface_air_pressure'):
            ref_raw, units, dims = cache[name]
            val = new[name]
            if units and val.units != units:
                val = val.to_units(units)
            if set(val.dims) == set(dims) and val.dims != tuple(dims):
                val = val.transpose(*dims)
            diff = np.abs(np.asarray(val.values, 'f8')
                          - ref_raw.astype('=f8')).max()
            print('  {:32s} {:10.3e}'.format(name, diff))


if __name__ == '__main__':
    main()
