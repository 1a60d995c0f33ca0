"""The f32 production fast path of the correlated-k radiation must track
the f64 golden-parity path.

The golden tests (test_golden_components.py) validate the f64 path:
exact table gathers in taumol and the Fortran Pade transmittance tables.
The production GCM and the benchmark run a different code path — float32,
one-hot dot contraction in taumol (components/rrtmg/interp.py) and the
analytic exponential in the solvers (use_tables=False) — which these
tests pin against the f64 reference on the same physical columns, plus a
regression test for the f32 exp underflow that produced NaNs through
1/zem1 in reftra.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from climt_tpu.components.rrtmg.lw_spectral import rrtmg_lw_fluxes
from climt_tpu.components.rrtmg.sw_spectral import (
    rrtmg_sw_fluxes, solar_variability)

G, AVOG, CPD = 9.80665, 6.022140857e23, 1004.64


def _columns(dtype, nz=40, ncol=16):
    rng = np.random.RandomState(42)
    p_sfc = 1013.0
    plev1 = np.linspace(p_sfc, 0.3, nz + 1)
    play1 = 0.5 * (plev1[:-1] + plev1[1:])

    def cols(profile, jitter=0.0):
        base = np.repeat(np.asarray(profile)[:, None], ncol, 1)
        if jitter:
            base = base * (1.0 + jitter * rng.randn(*base.shape))
        return jnp.asarray(base, dtype)

    tlay1 = np.maximum(300.0 - 60.0 * (1 - play1 / p_sfc) / 0.8, 205.0)
    tlev1 = np.concatenate([[302.0], 0.5 * (tlay1[:-1] + tlay1[1:]),
                            [tlay1[-1]]])
    play, plev = cols(play1), cols(plev1)
    tlay, tlev = cols(tlay1, 0.005), cols(tlev1)
    tsfc = jnp.asarray(295.0 + 10.0 * rng.rand(ncol), dtype)
    h2o = cols(0.016 * (play1 / p_sfc) ** 3, 0.05)
    o3 = cols(5e-6 * np.exp(-0.5 * ((np.log(play1) - np.log(20.0))
                                    / 1.2) ** 2))
    co2 = jnp.full_like(play, 355e-6)
    o2 = jnp.full_like(play, 0.21)
    zero = jnp.zeros_like(play)
    emis = jnp.ones((16, ncol), dtype)
    mu0 = jnp.asarray(np.linspace(1e-6, 1.0, ncol), dtype)
    alb = jnp.full((ncol,), 0.2, dtype)
    return dict(play=play, plev=plev, tlay=tlay, tlev=tlev, tsfc=tsfc,
                h2o=h2o, o3=o3, co2=co2, o2=o2, zero=zero, emis=emis,
                mu0=mu0, alb=alb, nz=nz, ncol=ncol)


def _lw(c, dtype, use_tables):
    z = c['zero'].astype(dtype)
    return rrtmg_lw_fluxes(
        c['play'].astype(dtype), c['plev'].astype(dtype),
        c['tlay'].astype(dtype), c['tlev'].astype(dtype),
        c['tsfc'].astype(dtype), c['h2o'].astype(dtype),
        c['o3'].astype(dtype), c['co2'].astype(dtype), z, z,
        c['o2'].astype(dtype), z, z, z, z, c['emis'].astype(dtype),
        z, jnp.zeros((c['nz'], c['ncol'], 16), dtype), z, z,
        jnp.full_like(z, 25.0), jnp.full_like(z, 10.0),
        jnp.zeros((c['nz'], c['ncol'], 16), dtype),
        G, AVOG, CPD, use_tables=use_tables)


def _sw(c, dtype, use_tables):
    z = c['zero'].astype(dtype)
    nocloud = (jnp.zeros((c['nz'], c['ncol'], 14), dtype),) * 4
    noaer = (jnp.zeros((c['nz'], c['ncol'], 14), dtype),) * 3
    alb = c['alb'].astype(dtype)
    return rrtmg_sw_fluxes(
        c['play'].astype(dtype), c['plev'].astype(dtype),
        c['tlay'].astype(dtype), c['h2o'].astype(dtype),
        c['o3'].astype(dtype), c['co2'].astype(dtype), z, z,
        c['o2'].astype(dtype), alb, alb, alb, alb,
        c['mu0'].astype(dtype), z, nocloud, noaer,
        1.0, -1, 0.0, -1, solar_variability(-1, 0.0),
        G, AVOG, CPD, icld=0, use_tables=use_tables)


def test_lw_f32_fastpath_tracks_f64():
    c = _columns(jnp.float64)
    ref = _lw(c, jnp.float64, use_tables=True)
    fast = _lw(c, jnp.float32, use_tables=False)
    # fluxes O(100 W/m^2): sub-W agreement; heating rates within 0.05 K/day
    for i in (0, 1):
        np.testing.assert_allclose(np.asarray(fast[i]),
                                   np.asarray(ref[i]), atol=0.5)
    np.testing.assert_allclose(np.asarray(fast[2]), np.asarray(ref[2]),
                               atol=0.05)


def test_sw_f32_fastpath_tracks_f64():
    c = _columns(jnp.float64)
    ref = _sw(c, jnp.float64, use_tables=True)
    fast = _sw(c, jnp.float32, use_tables=False)
    for i in (0, 1):
        np.testing.assert_allclose(np.asarray(fast[i]),
                                   np.asarray(ref[i]), atol=1.0)
    np.testing.assert_allclose(np.asarray(fast[4]), np.asarray(ref[4]),
                               atol=0.08)


def test_sw_f32_extreme_optical_depth_no_nan():
    """Regression: huge water path + grazing sun drove exp(-tau) to f32
    underflow and 1/zem1 to inf -> NaN before the EXPEPS clamp."""
    c = _columns(jnp.float32)
    c['h2o'] = c['h2o'] * 30.0          # pathological optical depths
    out = _sw(c, jnp.float32, use_tables=False)
    for arr in out:
        assert np.isfinite(np.asarray(arr)).all()


def test_lw_f32_extreme_no_nan():
    c = _columns(jnp.float32)
    c['h2o'] = c['h2o'] * 30.0
    out = _lw(c, jnp.float32, use_tables=False)
    for arr in out:
        assert np.isfinite(np.asarray(arr)).all()


def test_mix_rows_windowed_matches_full():
    """The per-level windowed key-species contraction must reproduce the
    full-table one-hot contraction exactly when indices fit the window
    (they are the same rows with the same weights), including across
    levels with different window bases."""
    from climt_tpu.components.rrtmg.interp import mix_rows, \
        mix_rows_windowed
    rng = np.random.RandomState(5)
    nz, ncol, rows, ng = 12, 64, 585, 16
    nspa = 9
    tbl = jnp.asarray(rng.rand(rows, ng), jnp.float32)
    # structured indices like taumol's: per-level jp base, per-cell jt/eta
    jp = np.clip((np.arange(nz) * 12 // nz)[:, None]
                 + rng.randint(0, 2, (nz, ncol)), 0, 11)
    terms = []
    for nsp_off in (0, 1):
        for eta_off in (0, 1):
            jt = rng.randint(0, 4, (nz, ncol))
            js = rng.randint(0, 8, (nz, ncol))
            idx = ((jp + nsp_off) * 5 + jt) * nspa + js + eta_off
            w = rng.rand(nz, ncol).astype('f4')
            terms.append((jnp.asarray(idx, jnp.int32), jnp.asarray(w)))
    full = mix_rows(tbl, terms)
    win = mix_rows_windowed(tbl, terms, 4 * 5 * nspa)
    np.testing.assert_allclose(np.asarray(win), np.asarray(full),
                               rtol=2e-6, atol=1e-7)


def test_mix_rows_windowed_drops_out_of_window():
    """An index outside the window must contribute exactly zero (safety
    drop), never a wrong row."""
    from climt_tpu.components.rrtmg.interp import mix_rows_windowed
    rows, ng, nz, ncol = 585, 8, 4, 8
    tbl = jnp.asarray(np.ones((rows, ng)), jnp.float32)
    idx = jnp.zeros((nz, ncol), jnp.int32)
    w = jnp.ones((nz, ncol), jnp.float32)
    far = jnp.full((nz, ncol), rows - 1, jnp.int32)
    out = mix_rows_windowed(tbl, [(idx, w), (far, w)], 40)
    # only the in-window term contributes (weight 1 x row of ones)
    np.testing.assert_allclose(np.asarray(out), 1.0, rtol=1e-6)
