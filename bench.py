"""Benchmark: moist GCM throughput on the spectral dynamical core.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...}.

Headline metric (BASELINE.md north star): grid-point-steps per second per
chip for the FULL moist GCM at T85-equivalent resolution (nlon=256,
nlat=128, nz=28, dt=600 s), one fused jit.  Physics is honest: REAL
correlated-k RRTMG radiation — the golden-matched 112-g-point shortwave
core and the 140-g-point longwave pipeline (surrogate-calibrated
k-tables, docs/RRTMG_LW_STATUS.md) — on an hourly lagged cadence
(rad_every=6, the reference's UpdateFrequencyWrapper pattern,
examples/gmd_aquaplanet.py:58-63), plus Emanuel convection, surface/PBL
physics, and a slab ocean.

Secondary metrics in the same JSON object:
- rrtmg_columns_per_s: standalone full correlated-k LW+SW radiation
  throughput (BASELINE.json metric #2), 60-level columns.
- secondary_heldsuarez_T42_gridpoint_steps_per_s: dry dynamical core.
- device: JAX's platform, device_kind and device count, and the card's
  name and power limit from nvidia-smi.

Cold-start wall time: the three programs (T85 moist scan, standalone
radiation, Held-Suarez scan) are compiled CONCURRENTLY via AOT
lower+compile in threads — XLA compilation releases the GIL — cutting
cold bench time to roughly the longest single compile.  The persistent
compilation cache (JAX_COMPILATION_CACHE_DIR, else .jax_cache) makes
repeat runs start in seconds.

The reference publishes no benchmark numbers (BASELINE.md); ``vs_baseline``
is measured against a nominal 1e6 gridpoint-steps/s single-node figure for
full-physics spectral GCMs of this size on CPU (a documented reference
point, not a measured climt number).
"""

import json
import os
import sys
import threading
import time

NOMINAL_BASELINE = 1.0e6  # gridpoint-steps/s, nominal single-node reference


REPO = os.path.dirname(os.path.abspath(__file__))


def measure_compiled(compiled, carry, n_steps, gridpoints):
    """Time a pre-compiled scan executable (one warm + one timed run)."""
    import jax
    out = compiled(carry)
    carry = out[0] if isinstance(out, tuple) and len(out) == 2 else out
    jax.block_until_ready(jax.tree_util.tree_leaves(carry)[0])
    t0 = time.perf_counter()
    out = compiled(carry)
    carry = out[0] if isinstance(out, tuple) and len(out) == 2 else out
    jax.block_until_ready(jax.tree_util.tree_leaves(carry)[0])
    elapsed = time.perf_counter() - t0
    return carry, gridpoints * n_steps / elapsed


def build_radiation_bench(nz=60, ncol=8192, dtype=None, use_tables=False,
                          sweep=None):
    """Jitted standalone correlated-k LW+SW radiation closure.

    Returns (rad, inputs): ``rad(inputs)`` is jitted and returns LW and SW
    up/down fluxes (W/m^2) and heating rates (K/day).  The columns are
    arguments, not constants, so XLA cannot fold the radiation at compile
    time.  The default is the production float32 fast path; ``use_tables``
    and ``sweep`` are rrtmg_lw_fluxes' switches (float64 with
    use_tables=True is the golden-parity path)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from climt_tpu.components.rrtmg.lw_spectral import rrtmg_lw_fluxes
    from climt_tpu.components.rrtmg.sw_spectral import (
        rrtmg_sw_fluxes, solar_variability)

    dtype = jnp.float32 if dtype is None else dtype
    p_sfc = 1013.0
    plev1 = np.linspace(p_sfc, 0.3, nz + 1)
    play1 = 0.5 * (plev1[:-1] + plev1[1:])
    tlay1 = np.maximum(300.0 - 60.0 * (1 - play1 / p_sfc) / 0.8, 205.0)
    tlev1 = np.concatenate([[302.0], 0.5 * (tlay1[:-1] + tlay1[1:]),
                            [tlay1[-1]]])

    def cols(x):
        return jnp.asarray(np.repeat(np.asarray(x)[:, None], ncol, 1),
                           dtype)

    inputs = {
        'play': cols(play1), 'plev': cols(plev1),
        'tlay': cols(tlay1), 'tlev': cols(tlev1),
        'tsfc': jnp.full((ncol,), 300.0, dtype),
        'h2o': cols(0.016 * (play1 / p_sfc) ** 3),
        'o3': cols(5e-6 * np.exp(-0.5 * ((np.log(play1) - np.log(20.0))
                                         / 1.2) ** 2)),
        'mu0': jnp.full((ncol,), 0.6, dtype),
        'alb': jnp.full((ncol,), 0.2, dtype),
    }
    solar_config = solar_variability(-1, 0.0)

    @jax.jit
    def rad(x):
        play, plev, alb = x['play'], x['plev'], x['alb']
        co2 = jnp.full_like(play, 355e-6)
        o2 = jnp.full_like(play, 0.21)
        zero = jnp.zeros_like(play)
        emis = jnp.ones((16, ncol), dtype)
        nocloud = (jnp.zeros((nz, ncol, 14), dtype),) * 4
        noaer = (jnp.zeros((nz, ncol, 14), dtype),) * 3
        lw = rrtmg_lw_fluxes(
            play, plev, x['tlay'], x['tlev'], x['tsfc'], x['h2o'], x['o3'],
            co2, zero, zero, o2, zero, zero, zero, zero, emis, zero,
            jnp.zeros((nz, ncol, 16), dtype), zero, zero,
            jnp.full_like(play, 25.0), jnp.full_like(play, 10.0),
            jnp.zeros((nz, ncol, 16), dtype), 9.80665, 6.022140857e23,
            1004.64, use_tables=use_tables, sweep=sweep)
        sw = rrtmg_sw_fluxes(
            play, plev, x['tlay'], x['h2o'], x['o3'], co2, zero, zero, o2,
            alb, alb, alb, alb, x['mu0'], zero, nocloud, noaer,
            1.0, -1, 0.0, -1, solar_config,
            9.80665, 6.022140857e23, 1004.64, icld=0,
            use_tables=use_tables)
        return {'lw_up': lw[0], 'lw_dn': lw[1], 'lw_hr': lw[2],
                'sw_up': sw[0], 'sw_dn': sw[1], 'sw_hr': sw[4]}

    return rad, inputs


def measure_radiation_compiled(compiled, inputs, repeats=3):
    import jax
    ncol = inputs['tsfc'].shape[0]
    out = compiled(inputs)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(repeats):
        out = compiled(inputs)
    jax.block_until_ready(out)
    elapsed = (time.perf_counter() - t0) / repeats
    return ncol / elapsed


def _phase(msg, _t0=[None]):
    if _t0[0] is None:
        _t0[0] = time.time()
    print('[bench {:6.1f}s] {}'.format(time.time() - _t0[0], msg),
          file=sys.stderr, flush=True)


def main():
    _phase('start')
    from climt_tpu.utils.compile_cache import enable_compile_cache
    from climt_tpu.utils.device import card_line
    card = card_line()               # before JAX touches the card
    enable_compile_cache(REPO)
    import jax
    import jax.numpy as jnp
    import numpy as np
    from climt_tpu.dycore.compiled import build_held_suarez_model
    from climt_tpu.dycore.moist_gcm import build_moist_gcm

    # headline: T85 moist GCM with real correlated-k radiation (hourly)
    nlon, nlat, nz = 256, 128, 28
    moist_steps, hs_steps = 24, 1000
    moist = build_moist_gcm(nlon=nlon, nlat=nlat, nz=nz, timestep=600.0,
                            dtype=jnp.float32, rad_every=6,
                            rad_col_chunk=8192)
    hs = build_held_suarez_model(nlon=128, nlat=64, nz=28,
                                 timestep=600.0, dtype=jnp.float32)
    rad_fn, rad_inputs = build_radiation_bench()
    _phase('models built')
    carry_m = moist[1]()
    carry_h = hs[1]()
    _phase('states initialized')

    # concurrent AOT compilation (XLA releases the GIL; the persistent
    # cache additionally dedupes across runs)
    compiled = {}
    errors = {}

    def compile_to(key, thunk):
        try:
            t0 = time.time()
            compiled[key] = thunk()
            _phase('%s compiled (%.0f s)' % (key, time.time() - t0))
        except Exception as err:            # surface in main thread
            errors[key] = err

    threads = [
        threading.Thread(target=compile_to, args=(
            'moist', lambda: moist[3].lower(carry_m, moist_steps)
            .compile())),
        threading.Thread(target=compile_to, args=(
            'rad', lambda: rad_fn.lower(rad_inputs).compile())),
        threading.Thread(target=compile_to, args=(
            'hs', lambda: hs[3].lower(carry_h, hs_steps).compile())),
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise next(iter(errors.values()))
    _phase('all programs compiled')

    carry_m, moist_rate = measure_compiled(
        compiled['moist'], carry_m, moist_steps, nlon * nlat * nz)
    _phase('moist measured: {:.3g} gps/s'.format(moist_rate))
    T = np.asarray(moist[0].sht.synthesize(carry_m[1]['T']))
    if np.isnan(T).any():
        print(json.dumps({
            'metric': 'moist_gcm_T85_gridpoint_steps_per_s',
            'value': 0.0, 'unit': 'gridpoint-steps/s',
            'vs_baseline': 0.0, 'error': 'NaN in output'}))
        sys.exit(1)

    rad_rate = measure_radiation_compiled(compiled['rad'], rad_inputs)
    _phase('radiation measured: {:.3g} col/s'.format(rad_rate))

    _, hs_rate = measure_compiled(compiled['hs'], carry_h, hs_steps,
                                  128 * 64 * 28)
    _phase('held-suarez measured: {:.3g} gps/s'.format(hs_rate))

    dev = jax.devices()[0]
    print(json.dumps({
        'metric': 'moist_gcm_T85_gridpoint_steps_per_s',
        'value': round(moist_rate, 1),
        'unit': 'gridpoint-steps/s',
        'vs_baseline': round(moist_rate / NOMINAL_BASELINE, 3),
        'radiation': 'correlated-k RRTMG LW(140gpt)+SW(112gpt), hourly',
        'rrtmg_columns_per_s': round(rad_rate, 1),
        'secondary_heldsuarez_T42_gridpoint_steps_per_s':
            round(hs_rate, 1),
        'device': {'platform': dev.platform, 'kind': dev.device_kind,
                   'count': len(jax.devices()), 'card': card},
    }))


if __name__ == '__main__':
    main()
