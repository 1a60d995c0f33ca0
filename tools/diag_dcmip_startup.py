"""Test start-up-scheme hypotheses for the Dcmip divergence residual.

The one-step cache comparison runs SpectralDycore.initial_step (half-
then-full Euler).  This script re-runs the case with alternative first-
step schemes and prints the m=0 divergence coefficients against the
cache, to attribute (or fix) the ~30% mismatch in the roundoff-scale
zonal-mean divergence generation (tools/diag_dcmip_residual2.py).
CPU: JAX_PLATFORMS=cpu \
    python tools/diag_dcmip_startup.py
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
from climt_tpu.dycore.spectral_dynamics import SpectralDycore
from golden import CACHE_DIR, load_cache


def run_with_scheme(scheme):
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

    orig = SpectralDycore.initial_step

    def euler(self, now, phys=None, dt=None, physics_fn=None):
        dt = self.dt if dt is None else dt
        tend, _ = self.explicit_tendencies(now, phys, physics_fn)
        new = {k: now[k] + dt * tend[k] for k in now}
        for key in ('vort', 'div', 'T', 'q'):
            new[key] = new[key] * self.hyperdiff_factor_start[None]
        return now, new

    def leapfrog_si(self, now, phys=None, dt=None, physics_fn=None):
        # semi-implicit leapfrog from rest: prev = now, half timestep so
        # the 2*dt leapfrog interval equals dt (GFS-style start)
        dt = self.dt if dt is None else dt
        saved_dt = self.dt
        _, new, _ = self.step(now, now, phys=phys, dt=0.5 * dt,
                              physics_fn=physics_fn)
        return now, new

    schemes = {'half_full': orig, 'euler': euler,
               'leapfrog_si': leapfrog_si}
    SpectralDycore.initial_step = schemes[scheme]
    try:
        _, new = dyc(state, timedelta(seconds=10))
    finally:
        SpectralDycore.initial_step = orig
    return dyc, new


def main():
    cache = load_cache(
        '{}/TestGFSDycoreWithDcmipInitialConditions-3d-1.cache'.format(
            CACHE_DIR))
    ref_raw, units, dims = cache['divergence_of_wind']
    ref = ref_raw.astype('=f8')
    if dims[0] == 'lon':
        ref = np.transpose(ref, (2, 1, 0))
    vref_raw, vunits, vdims = cache['northward_wind']
    vref = vref_raw.astype('=f8')
    if vdims[0] == 'lon':
        vref = np.transpose(vref, (2, 1, 0))

    for scheme in ('half_full', 'euler', 'leapfrog_si'):
        dyc, new = run_with_scheme(scheme)
        sht = dyc._dycore.sht
        val = new['divergence_of_wind']
        if set(val.dims) == set(dims) and val.dims != tuple(dims):
            val = val.transpose(*dims)
        ours = np.asarray(val.values, 'f8')
        if dims[0] == 'lon':
            ours = np.transpose(ours, (2, 1, 0))
        s_res = np.asarray(sht.analyze(ours - ref))[:, 0, :]
        s_ref = np.asarray(sht.analyze(ref))[:, 0, :]
        vval = new['northward_wind']
        if set(vval.dims) == set(vdims) and vval.dims != tuple(vdims):
            vval = vval.transpose(*vdims)
        vours = np.asarray(vval.values, 'f8')
        if vdims[0] == 'lon':
            vours = np.transpose(vours, (2, 1, 0))
        print('{:12s}  v_maxdiff {:9.3e}   div m0 res n=2,4,6: '
              '{:9.2e} {:9.2e} {:9.2e}   (ref n=2: {:9.2e})'.format(
                  scheme, np.abs(vours - vref).max(),
                  s_res[18, 2].real, s_res[18, 4].real,
                  s_res[18, 6].real, s_ref[18, 2].real))


if __name__ == '__main__':
    main()
