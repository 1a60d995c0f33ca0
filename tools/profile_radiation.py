"""Per-stage timing of the correlated-k radiation pipeline on the GPU.

Times setcoef/taumol/rtrn (LW) and setcoef/taumol/spcvrt (SW)
separately, plus the fused drivers, so optimization work targets the
measured hot stage rather than a guess.  Run: python tools/profile_radiation.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

t_start = time.time()


def log(msg):
    print('[{:7.1f}s] {}'.format(time.time() - t_start, msg), flush=True)


def bench_fn(fn, *args, repeats=5):
    import jax
    out = fn(*args)                       # compile
    jax.block_until_ready(jax.tree_util.tree_leaves(out)[0])
    t0 = time.perf_counter()
    for _ in range(repeats):
        out = fn(*args)
    jax.block_until_ready(jax.tree_util.tree_leaves(out)[0])
    return (time.perf_counter() - t0) / repeats


def main():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from bench import enable_compile_cache
    enable_compile_cache()
    log('devices: {}'.format(jax.devices()))

    from climt_tpu.components.rrtmg import lw_spectral as L
    from climt_tpu.components.rrtmg import sw_spectral as S

    dtype = jnp.float32
    nz, ncol = 60, 8192
    p_sfc = 1013.0
    plev1 = np.linspace(p_sfc, 0.3, nz + 1)
    play1 = 0.5 * (plev1[:-1] + plev1[1:])
    tlay1 = np.maximum(300.0 - 60.0 * (1 - play1 / p_sfc) / 0.8, 205.0)
    tlev1 = np.concatenate([[302.0], 0.5 * (tlay1[:-1] + tlay1[1:]),
                            [tlay1[-1]]])

    def cols(x):
        return jnp.asarray(np.repeat(np.asarray(x)[:, None], ncol, 1),
                           dtype)

    play, plev = cols(play1), cols(plev1)
    tlay, tlev = cols(tlay1), cols(tlev1)
    tsfc = jnp.full((ncol,), 300.0, dtype)
    h2o = cols(0.016 * (play1 / p_sfc) ** 3)
    o3 = cols(5e-6 * np.exp(-0.5 * ((np.log(play1) - np.log(20.0))
                                    / 1.2) ** 2))
    co2 = jnp.full_like(play, 355e-6)
    o2 = jnp.full_like(play, 0.21)
    zero = jnp.zeros_like(play)
    emis = jnp.ones((16, ncol), dtype)

    # ---------------- LW stages -----------------------------------------
    grav, avogad, cpd = 9.80665, 6.022140857e23, 1004.64

    @jax.jit
    def lw_inatm_setcoef():
        vmr = dict(h2o=h2o, co2=co2, o3=o3, n2o=zero, co=zero,
                   ch4=zero, o2=o2)
        coldry, wkl, wbroad, pwvcm = L.inatm_lw(
            play, plev, tlay, vmr, grav, avogad)
        cs = L.setcoef_lw(play, tlay, tlev, tsfc, emis, coldry, wkl,
                          wbroad)
        cs['pavel'] = play
        return cs, pwvcm

    (cs, pwv) = lw_inatm_setcoef()
    jax.block_until_ready(pwv)
    log('LW inatm+setcoef compiled (timing skipped; cheap)')

    wx = {name: jnp.zeros_like(play)
          for name in ('ccl4', 'cfc11', 'cfc12', 'cfc22')}

    @jax.jit
    def lw_taumol(cs):
        return L.taumol_lw(cs, wx, dtype)

    taug, fracs = lw_taumol(cs)
    t = bench_fn(lw_taumol, cs)
    log('LW taumol:        {:7.2f} ms'.format(t * 1e3))

    heatfac = grav * 8.64e4 / (cpd * 1.0e2)

    @jax.jit
    def lw_rtrn(taug, fracs, cs, pwv):
        return L.rtrn_lw(taug, fracs, cs['planklay'], cs['planklev'],
                         cs['plankbnd'], emis, pwv, zero,
                         jnp.zeros((nz, ncol, 16), dtype), plev,
                         heatfac, use_tables=False)

    out = lw_rtrn(taug, fracs, cs, pwv)
    t = bench_fn(lw_rtrn, taug, fracs, cs, pwv)
    log('LW rtrn:          {:7.2f} ms'.format(t * 1e3))

    # ---------------- SW stages -----------------------------------------
    pdp = plev[:-1] - plev[1:]
    amm = (1.0 - h2o) * S.AMD + h2o * S.AMW
    coldry_sw = pdp * 1.0e3 * avogad / (1.0e2 * grav * amm * (1.0 + h2o))
    wkl_sw = {g: v * coldry_sw for g, v in (
        ('h2o', h2o), ('co2', co2), ('o3', o3), ('n2o', zero),
        ('ch4', zero), ('o2', o2))}
    solar_config = S.solar_variability(-1, 0.0)
    (svar_f, svar_s, svar_i, svf_b, svs_b, svi_b, solvar) = solar_config
    mu0 = jnp.full((ncol,), 0.6, dtype)
    alb = jnp.full((ncol,), 0.2, dtype)

    @jax.jit
    def sw_setcoef():
        return S.setcoef_sw(play, tlay, coldry_sw, wkl_sw)

    cs_sw = sw_setcoef()
    jax.block_until_ready(cs_sw['jp'])
    log('SW setcoef compiled (timing skipped; cheap)')

    @jax.jit
    def sw_taumol(cs_sw):
        return S.taumol_sw(cs_sw, -1, svar_f, svar_s, svar_i,
                           svf_b, svs_b, svi_b, dtype)

    taug_sw, taur_sw, sflux = sw_taumol(cs_sw)
    t = bench_fn(sw_taumol, cs_sw)
    log('SW taumol:        {:7.2f} ms'.format(t * 1e3))

    import functools

    @functools.partial(jax.jit, static_argnums=(3, 4))
    def sw_spcvrt(taug_sw, taur_sw, sflux, icld, use_tables):
        zero_b = jnp.zeros((nz, ncol, 14), dtype)
        one_b = jnp.ones((nz, ncol, 14), dtype)
        alb_b = jnp.stack([alb] * 14, axis=-1)
        return S.spcvrt_sw(taug_sw, taur_sw, sflux,
                           jnp.ones(14, dtype), mu0, alb_b, alb_b,
                           zero, zero_b, one_b, zero_b,
                           zero_b, one_b, zero_b, icld=icld,
                           use_tables=use_tables)

    for icld, ut, label in ((0, True, 'tables, icld=0'),
                            (0, False, 'exp,    icld=0'),
                            (1, False, 'exp,    icld=1')):
        out = sw_spcvrt(taug_sw, taur_sw, sflux, icld, ut)
        t = bench_fn(sw_spcvrt, taug_sw, taur_sw, sflux, icld, ut)
        log('SW spcvrt ({}): {:7.2f} ms'.format(label, t * 1e3))

    log('done (fused-driver totals come from bench.py: 8192 col / 1.5 s)')


if __name__ == '__main__':
    main()
