"""Phase-by-phase timing of the flagship bench configurations.

Prints one line per phase (compile and steady-state times separately) so
bench.py regressions can be attributed.  Run on the GPU:

    python tools/profile_step.py [--quick]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

t_start = time.time()


def log(msg):
    print('[{:8.1f}s] {}'.format(time.time() - t_start, msg), flush=True)


def timed(fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    import jax
    jax.block_until_ready(jax.tree_util.tree_leaves(out)[0])
    # run_fn may return carry or (carry, diagnostics)
    carry = out[0] if isinstance(out, tuple) and len(out) == 2 else out
    return carry, time.perf_counter() - t0


def main():
    quick = '--quick' in sys.argv
    import jax
    import jax.numpy as jnp
    log('jax devices: {}'.format(jax.devices()))

    from climt_tpu.dycore.moist_gcm import build_moist_gcm
    from climt_tpu.dycore.compiled import build_held_suarez_model

    # ---- Held-Suarez T42 dry core ------------------------------------
    hs = build_held_suarez_model(nlon=128, nlat=64, nz=28,
                                 timestep=600.0, dtype=jnp.float32)
    carry, t = timed(hs[1])
    log('HS T42 init: {:.2f}s'.format(t))
    carry, t = timed(hs[3], carry, 200)
    log('HS T42 200-step compile+run: {:.2f}s'.format(t))
    for _ in range(2):
        carry, t = timed(hs[3], carry, 200)
        gps = 128 * 64 * 28 * 200 / t
        log('HS T42 200 steps: {:.2f}s -> {:.3g} gridpoint-steps/s'
            .format(t, gps))

    # ---- moist GCM ----------------------------------------------------
    nlon, nlat, nz = (128, 64, 28) if quick else (256, 128, 28)
    moist = build_moist_gcm(nlon=nlon, nlat=nlat, nz=nz, timestep=600.0,
                            dtype=jnp.float32, rad_every=6,
                            rad_col_chunk=8192)
    log('moist GCM built (nlon={}, nlat={})'.format(nlon, nlat))
    carry, t = timed(moist[1])
    log('moist init: {:.2f}s'.format(t))

    for n in (6, 6, 12):
        carry, t = timed(moist[3], carry, n)
        gps = nlon * nlat * nz * n / t
        log('moist {}-step run: {:.2f}s -> {:.3g} gridpoint-steps/s'
            .format(n, t, gps))

    # ---- standalone radiation ------------------------------------------
    import bench
    t0 = time.perf_counter()
    rad_fn, rad_inputs = bench.build_radiation_bench()
    compiled = rad_fn.lower(rad_inputs).compile()
    rate = bench.measure_radiation_compiled(compiled, rad_inputs)
    log('radiation (60 lev, 8192 col) incl compile: {:.2f}s total, '
        '{:.3g} columns/s steady'.format(time.perf_counter() - t0, rate))


if __name__ == '__main__':
    main()
