"""Isolate the TestGFSDycoreWithDcmipInitialConditions northward-wind
residual (~1.7e-4 m/s, tests/test_dycore_golden.py).

Decomposes the (ours - cache) differences of every prognostic in
spectral space (per m, n, level) to characterize the unexplained term.
Run on CPU: JAX_PLATFORMS=cpu \
    python tools/diag_dcmip_residual.py
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
    print('truncation T =', sht.trunc if hasattr(sht, 'trunc') else '?')

    for name in ('northward_wind', 'eastward_wind',
                 'divergence_of_wind', 'atmosphere_relative_vorticity'):
        ref_raw, units, dims = cache[name]
        val = new[name]
        if units and val.units != units:
            val = val.to_units(units)
        if set(val.dims) == set(dims) and val.dims != tuple(dims):
            val = val.transpose(*dims)
        diff = np.asarray(val.values, dtype='f8') - ref_raw.astype('=f8')
        # val dims: (lon, lat, z)? print and normalize to (z, lat, lon)
        print('\n===', name, 'dims', dims, 'max', np.abs(diff).max())
        d = diff
        if dims[0] == 'lon':
            d = np.transpose(diff, (2, 1, 0))     # (z, lat, lon)
        # vertical profile of the residual
        prof = np.abs(d).max(axis=(1, 2))
        print('per-level max:', np.array2string(
            prof, precision=2, max_line_width=75))
        # spectral structure at the worst level
        lev = int(np.argmax(prof))
        spec = np.asarray(sht.analyze(
            np.asarray(d[lev:lev + 1], dtype='f8')))[0]
        amp = np.abs(spec)
        print('worst level {}: spectral max {:.3e}'.format(
            lev, amp.max()))
        m_power = amp.max(axis=1)
        n_power = amp.max(axis=0)
        print('power by m (first 10):', np.array2string(
            m_power[:10], precision=2, max_line_width=75))
        print('power by n (first 10):', np.array2string(
            n_power[:10], precision=2, max_line_width=75))
        # zonal-mean component parity in n
        print('m=0 |a_n|:', np.array2string(
            amp[0, :10], precision=2, max_line_width=75))


if __name__ == '__main__':
    main()
