"""Emanuel-Zivkovic-Rothman buoyancy-sorting convection scheme (v4.3c).

Behavioral parity target: the reference's Fortran CONVECT + TLIFT
(/root/reference/climt/_lib/emanuel/convect43c.f90:145-1207, wrapped at
climt/_components/emanuel/component.py:17-308).  The algorithm: find the
parcel origin level (max moist static energy below the MSE minimum), its
LCL and first level above (cloud base), lift the parcel (two-iteration
saturation-point solve), accumulate CAPE to find the top of convection,
relax the cloud-base mass flux toward subcloud quasi-equilibrium, build the
buoyancy-sorted entrainment/detrainment matrix (mixing fractions s_ij),
integrate the precipitating downdraft with rain/snow evaporation, and
assemble tendencies with an exact enthalpy/momentum conservation fix.

Vectorized design (SURVEY.md §2.3 hard part (b)): the reference's serial
per-column loop with data-dependent levels (cloud base/top) becomes
whole-grid fixed-shape computation — per-column integer levels (nk, icb,
inb, ...) are carried as index arrays, level-dependent regions become
boolean masks, the (level x level) mixing matrix is computed densely, and
the few genuinely sequential vertical recurrences (running CAPE, the
downdraft descent) are ``lax.scan`` over the (short) level axis with all
columns batched.  Everything is jit-compatible; no Python branching on
data.

The reference component passes (Cpd, Cpv) where bolton_q_sat expects the
gas constants (component.py:274-278), making its saturation humidity use
epsilon = Cpd/Cpv; reproduced for parity.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core.base_components import ImplicitTendencyComponent, \
    timestep_seconds
from ..core.constants import get_constant
from ..core.util import bolton_q_sat
from ..ops.precision import dot_precision

_EPMAX = 0.999


def _take_level(arr, idx):
    """arr (ncol, nz), idx (ncol,) -> arr[col, idx[col]]."""
    return jnp.take_along_axis(arr, idx[:, None], axis=1)[:, 0]


def lifted_parcel(T, q, qs, p, gz, nk, icb, nl0, params):
    """TLIFT: temperature/virtual temperature/condensate of a parcel
    lifted from level ``nk`` (dry below cloud base ``icb``, reversibly
    saturated above), vectorized over columns.

    Mirrors the reference's TLIFT (convect43c.f90:1136-1207): the
    saturated ascent conserves the liquid-water static energy ah0 of the
    origin level and solves the implicit parcel-temperature equation
    with two Newton iterations; the Fortran's saturation vapor pressure
    (Bolton above freezing, integrated Clausius-Clapeyron below) is
    applied per iterate.  Value-validated against an exact root solve in
    tests/test_emanuel_values.py.

    Args:
        T, q, qs, p, gz: (ncol, nz) bottom-up profiles (p in mb, gz in
            J/kg).
        nk, icb: (ncol,) int origin and cloud-base level indices.
        nl0: 0-based index of the highest convecting level.
        params: scheme-constant dict (cpd, cpv, cl, rv, rd, lv0).

    Returns (tp, tvp, clw): each (ncol, nz).
    """
    cpd, cpv, cl = params['cpd'], params['cpv'], params['cl']
    rv, rd, lv0 = params['rv'], params['rd'], params['lv0']
    cpvmcl = cl - cpv
    eps = rd / rv
    epsi = 1.0 / eps
    nz = T.shape[1]
    k = jnp.arange(nz)[None, :]

    T_nk = _take_level(T, nk)
    q_nk = _take_level(q, nk)
    gz_nk = _take_level(gz, nk)

    ah0 = ((cpd * (1.0 - q_nk) + cl * q_nk) * T_nk
           + q_nk * (lv0 - cpvmcl * (T_nk - 273.15)) + gz_nk)
    cpp = cpd * (1.0 - q_nk) + q_nk * cpv

    tp_dry = T_nk[:, None] - (gz - gz_nk[:, None]) / cpp[:, None]
    tvp_dry = tp_dry * (1.0 + q_nk[:, None] * epsi)

    # saturated lift: two Newton iterations at every level
    tg = T
    qg = qs
    alv = lv0 - cpvmcl * (T - 273.15)
    for _ in range(2):
        s = 1.0 / (cpd + alv * alv * qg / (rv * T * T))
        ahg = cpd * tg + (cl - cpd) * q_nk[:, None] * T + alv * qg + gz
        tg = jnp.maximum(tg + s * (ah0[:, None] - ahg), 35.0)
        tc = tg - 273.15
        es = jnp.where(
            tc >= 0.0,
            6.112 * jnp.exp(17.67 * tc / (243.5 + tc)),
            jnp.exp(23.33086 - 6111.72784 / tg + 0.15215 * jnp.log(tg)))
        qg = eps * es / jnp.maximum(p - es * (1.0 - eps), 1e-30)
    tp_sat = (ah0[:, None] - (cl - cpd) * q_nk[:, None] * T - gz
              - alv * qg) / cpd
    clw = jnp.maximum(q_nk[:, None] - qg, 0.0)
    rg = qg / (1.0 - q_nk[:, None])
    tvp_sat = tp_sat * (1.0 + rg * epsi)

    below_cb = k < icb[:, None]
    tp = jnp.where(below_cb, tp_dry, tp_sat)
    tvp = jnp.where(below_cb, tvp_dry, tvp_sat)
    clw = jnp.where(below_cb, 0.0, clw)
    # virtual-temperature correction TVP -= TP * q(NK)
    tvp = tvp - tp * q_nk[:, None]
    # extend one level above NL
    tvp = tvp.at[:, nl0 + 1].set(
        tvp[:, nl0] - (_take_level(gz, jnp.full_like(nk, nl0 + 1))
                       - gz[:, nl0]) / cpd)
    return tp, tvp, clw


@partial(jax.jit, static_argnums=(9,))
def emanuel_convect(T, q, qs, u, v, p, ph, cbmf_in, dt, nl, params):
    """One call of the convection scheme over all columns.

    Args:
        T, q, qs, u, v: (ncol, nz) bottom-up profiles; p (ncol, nz) and
            ph (ncol, nz+1) pressures in mb.
        cbmf_in: (ncol,) cloud-base mass flux memory.
        dt: timestep seconds.
        nl: static int, highest level for convection (Fortran NL, 1-based
            count; = nz - 3 in the reference wrapper).
        params: dict of scheme constants.

    Returns dict with ft, fq, fu, fv (tendencies), precip, wd, tprime,
    qprime, cbmf, cape, iflag.
    """
    ncol, nz = T.shape
    k = jnp.arange(nz)[None, :]                      # level index row
    cpd, cpv, cl = params['cpd'], params['cpv'], params['cl']
    rv, rd = params['rv'], params['rd']
    lv0, g, rowl = params['lv0'], params['g'], params['rowl']
    sigd, sigs = params['sigd'], params['sigs']
    entp = params['entp']
    elcrit, tlcrit = params['elcrit'], params['tlcrit']
    omtrain, omtsnow = params['omtrain'], params['omtsnow']
    coeffr, coeffs = params['coeffr'], params['coeffs']
    cu, beta = params['cu'], params['beta']
    dtmax = params['dtmax']
    alpha, damp, delt0 = params['alpha'], params['damp'], params['delt0']
    minorig = params['minorig']                       # 0-based origin floor

    cpvmcl = cl - cpv
    eps = rd / rv
    epsi = 1.0 / eps
    ginv = 1.0 / g

    nl0 = nl - 1          # 0-based index of Fortran level NL
    dph = ph[:, :-1] - ph[:, 1:]                     # (ncol, nz) positive

    # ---- geopotential, heat capacity, static energies -----------------
    tv = T * (1.0 + q * epsi - q)
    gz_incr = jnp.zeros_like(T).at[:, 1:].set(
        0.5 * rd * (tv[:, 1:] + tv[:, :-1])
        * (p[:, :-1] - p[:, 1:]) / ph[:, 1:-1])
    gz = jnp.cumsum(gz_incr, axis=1)
    cpn = cpd * (1.0 - q) + cpv * q
    h = T * cpn + gz
    lv = lv0 - cpvmcl * (T - 273.15)
    hm = (cpd * (1.0 - q) + cl * q) * (T - T[:, :1]) + lv * q + gz
    hm = hm.at[:, 0].set(lv[:, 0] * q[:, 0])
    lvcp = lv / cpn

    # ---- level of minimum moist static energy (sequential criterion) --
    def ihmin_scan(carry, xs):
        ahmin, ihmin = carry
        hm_k, hm_km1, kk = xs
        take = (hm_k < ahmin) & (hm_k < hm_km1) & (kk >= jnp.maximum(
            minorig, 1))
        ahmin = jnp.where(take, hm_k, ahmin)
        ihmin = jnp.where(take, kk, ihmin)
        return (ahmin, ihmin), None

    init = (jnp.full((ncol,), 1e12), jnp.full((ncol,), nl0, dtype=jnp.int32))
    ks = jnp.arange(1, nl0 + 2, dtype=jnp.int32)
    (_, ihmin), _ = jax.lax.scan(
        ihmin_scan, init,
        (hm[:, 1:nl0 + 2].T, hm[:, 0:nl0 + 1].T,
         jnp.broadcast_to(ks[:, None], (nl0 + 1, ncol))))
    ihmin = jnp.minimum(ihmin, nl0 - 1)

    # ---- parcel origin level nk: max hm in [minorig, ihmin] ------------
    in_range = (k >= minorig) & (k <= ihmin[:, None])
    hm_for_max = jnp.where(in_range & (hm > 0.0), hm, -jnp.inf)
    nk = jnp.argmax(hm_for_max, axis=1).astype(jnp.int32)
    any_pos = jnp.any(hm_for_max > -jnp.inf, axis=1)
    nk = jnp.where(any_pos, nk, 0)

    T_nk = _take_level(T, nk)
    q_nk = _take_level(q, nk)
    qs_nk = _take_level(qs, nk)
    p_nk = _take_level(p, nk)
    gz_nk = _take_level(gz, nk)

    no_conv0 = (T_nk < 250.0) | (q_nk <= 0.0) | (ihmin == nl0 - 1)

    # ---- lifted condensation level -------------------------------------
    rh = q_nk / jnp.maximum(qs_nk, 1e-30)
    chi = T_nk / (1669.0 - 122.0 * rh - T_nk)
    plcl = p_nk * jnp.maximum(rh, 1e-30) ** chi
    no_conv2 = (plcl < 200.0) | (plcl >= 2000.0)

    # ---- first level fully above the LCL (cloud base icb) --------------
    above_lcl = (p < plcl[:, None]) & (k > nk[:, None]) & (
        k <= nl0)
    icb = jnp.where(
        jnp.any(above_lcl, axis=1),
        jnp.argmax(above_lcl, axis=1),
        nl0 - 1).astype(jnp.int32)
    icb = jnp.minimum(icb, nl0 - 1)
    no_conv3 = icb >= (nl0 - 1)

    # guard indices for inactive columns
    safe = ~(no_conv0 | no_conv2 | no_conv3)
    icb_s = jnp.clip(icb, 1, nz - 3)
    nk_s = jnp.clip(nk, 0, nz - 4)

    # ---- lifted parcel (TLIFT): dry below cloud base, saturated above --
    tp, tvp, clw = lifted_parcel(T, q, qs, p, gz, nk, icb_s, nl0, params)

    # ---- stability check at cloud base ---------------------------------
    tv_icb = _take_level(tv, icb_s)
    tvp_icb = _take_level(tvp, icb_s)
    stable_skip = (cbmf_in == 0.0) & (tvp_icb <= tv_icb - dtmax)

    # ---- precipitation efficiencies ------------------------------------
    tca = tp - 273.15
    elacrit = jnp.where(tca >= 0.0, elcrit,
                        elcrit * (1.0 - tca / tlcrit))
    elacrit = jnp.maximum(elacrit, 0.0)
    ep = _EPMAX * (1.0 - elacrit / jnp.maximum(clw, 1e-8))
    ep = jnp.clip(ep, 0.0, _EPMAX)
    ep = jnp.where(k <= nk_s[:, None], 0.0, ep)
    sigp = jnp.full_like(T, sigs)

    # ---- CAPE and top of convection (inb) ------------------------------
    by = (tvp - tv) * dph / p                      # buoyancy integrand

    def cape_scan(carry, xs):
        cape, capem, byp, inb, inb1 = carry
        by_i, by_ip1, kk = xs
        active = (kk >= icb_s + 1) & (kk <= nl0 - 1)
        cape_new = jnp.where(active, cape + by_i, cape)
        inb1 = jnp.where(active & (by_i >= 0.0), kk + 1, inb1)
        pos = active & (cape_new > 0.0)
        inb = jnp.where(pos, kk + 1, inb)
        byp = jnp.where(pos, by_ip1, byp)
        capem = jnp.where(pos, cape_new, capem)
        return (cape_new, capem, byp, inb, inb1), None

    ks_full = jnp.arange(nz - 1, dtype=jnp.int32)
    init = (jnp.zeros(ncol), jnp.zeros(ncol), jnp.zeros(ncol),
            icb_s + 1, icb_s + 1)
    (cape_run, capem, byp, inb, inb1), _ = jax.lax.scan(
        cape_scan, init,
        (by[:, :-1].T, by[:, 1:].T,
         jnp.broadcast_to(ks_full[:, None], (nz - 1, ncol))))
    inb = jnp.maximum(inb, inb1)
    inb = jnp.clip(inb, icb_s + 1, nl0)
    cape = capem + byp
    defrac = jnp.maximum(capem - cape, 0.001)
    frac = jnp.clip(-cape / defrac, 0.0, 1.0)

    # ---- liquid water static energy of lifted parcel -------------------
    in_cloud = (k >= icb_s[:, None]) & (k <= inb[:, None])
    hp = jnp.where(in_cloud,
                   _take_level(h, nk_s)[:, None]
                   + (lv + (cpd - cpv) * T) * ep * clw,
                   h)

    # ---- cloud base mass flux relaxation -------------------------------
    icbm1 = jnp.clip(icb_s - 1, 0, nz - 1)
    tvp_icbm1 = _take_level(tvp, icbm1)
    p_icbm1 = _take_level(p, icbm1)
    cpn_icbm1 = _take_level(cpn, icbm1)
    tvpplcl = tvp_icbm1 - rd * tvp_icbm1 * (p_icbm1 - plcl) / (
        cpn_icbm1 * p_icbm1)
    tvp_icbp1 = _take_level(tvp, jnp.clip(icb_s + 1, 0, nz - 1))
    p_icb = _take_level(p, icb_s)
    p_icbp1 = _take_level(p, jnp.clip(icb_s + 1, 0, nz - 1))
    tvaplcl = tv_icb + (tvp_icb - tvp_icbp1) * (plcl - p_icb) / (
        p_icb - p_icbp1)
    pbl_mask = (k >= nk_s[:, None]) & (k <= icbm1[:, None])
    dtpbl = jnp.sum(jnp.where(pbl_mask, (tvp - tv) * dph, 0.0), axis=1)
    ph_nk = _take_level(ph[:, :-1], nk_s)
    ph_icb = _take_level(ph[:, :-1], icb_s)
    dtpbl = dtpbl / jnp.maximum(ph_nk - ph_icb, 1e-10)
    dtma = tvpplcl - tvaplcl + dtmax + dtpbl

    damps = damp * dt / delt0
    cbmf = jnp.maximum((1.0 - damps) * cbmf_in + 0.1 * alpha * dtma, 0.0)
    zero_flux_skip = (cbmf == 0.0) & (cbmf_in == 0.0)

    active = safe & ~stable_skip & ~zero_flux_skip

    # ---- mixing rates m(i) ---------------------------------------------
    k_eff = jnp.minimum(k, inb1[:, None])
    tv_eff = jnp.take_along_axis(tv, k_eff, axis=1)
    tvp_eff = jnp.take_along_axis(tvp, k_eff, axis=1)
    dph_eff = jnp.take_along_axis(dph, jnp.minimum(k_eff, nz - 1), axis=1)
    dbo = jnp.abs(tv_eff - tvp_eff) + entp * 0.02 * dph_eff
    m_mask = (k >= icb_s[:, None] + 1) & (k <= inb[:, None])
    dbosum = jnp.sum(jnp.where(m_mask, dbo, 0.0), axis=1)
    m = jnp.where(m_mask, cbmf[:, None] * dbo
                  / jnp.maximum(dbosum, 1e-30)[:, None], 0.0)

    # ---- buoyancy-sorted mixing matrix sij / ment / qent ---------------
    # i = updraft origin level (rows), j = mixing level (cols)
    q_nk_c = q_nk[:, None, None]
    qti = (q_nk[:, None] - ep * clw)                 # (ncol, nz) per i
    Ti = T[:, :, None]
    Tj = T[:, None, :]
    hi = h[:, :, None]
    hj = h[:, None, :]
    hpi = hp[:, :, None]
    qi = q[:, :, None]
    qj = q[:, None, :]
    qsj = qs[:, None, :]
    lvj = lv[:, None, :]
    clwj = clw[:, None, :]
    epj = ep[:, None, :]
    qti_i = qti[:, :, None]

    bf2 = 1.0 + lvj * lvj * qsj / (rv * Tj * Tj * cpd)
    anum = hj - hpi + (cpv - cpd) * Tj * (qti_i - qj)
    denom = hi - hpi + (cpd - cpv) * (qi - qti_i) * Tj
    dei = jnp.where(jnp.abs(denom) < 0.01, 0.01, denom)
    sij = anum / dei
    eye = jnp.eye(nz)[None]
    sij = jnp.where(eye > 0, 1.0, sij)
    altem = (sij * qi + (1.0 - sij) * qti_i - qsj) / bf2
    cwat = clwj * (1.0 - epj)
    ij_j = jnp.arange(nz)[None, None, :]
    ij_i = jnp.arange(nz)[None, :, None]
    need_alt = ((sij < 0.0) | (sij > 1.0) | (altem > cwat)) & (ij_j > ij_i)
    anum2 = anum - lvj * (qti_i - qsj - cwat * bf2)
    denom2 = denom + lvj * (qi - qti_i)
    denom2 = jnp.where(jnp.abs(denom2) < 0.01, 0.01, denom2)
    sij2 = anum2 / denom2
    altem2 = sij2 * qi + (1.0 - sij2) * qti_i - qsj - (bf2 - 1.0) * cwat
    sij = jnp.where(need_alt, sij2, sij)
    altem = jnp.where(need_alt, altem2, altem)

    valid_ij = ((k[:, :, None] >= icb_s[:, None, None] + 1)
                & (k[:, :, None] <= inb[:, None, None])
                & (k[:, None, :] >= icb_s[:, None, None])
                & (k[:, None, :] <= inb[:, None, None]))
    entrains = (sij > 0.0) & (sij < 0.9) & valid_ij
    qent = jnp.where(entrains, sij * qi + (1.0 - sij) * qti_i,
                     jnp.broadcast_to(qj, sij.shape))
    u_i = u[:, :, None]
    v_i = v[:, :, None]
    u_nk = _take_level(u, nk_s)[:, None, None]
    v_nk = _take_level(v, nk_s)[:, None, None]
    uent = jnp.where(entrains, sij * u_i + (1.0 - sij) * u_nk,
                     jnp.broadcast_to(u[:, None, :], sij.shape))
    vent = jnp.where(entrains, sij * v_i + (1.0 - sij) * v_nk,
                     jnp.broadcast_to(v[:, None, :], sij.shape))
    elij = jnp.where(entrains, jnp.maximum(altem, 0.0), 0.0)
    ment = jnp.where(entrains,
                     m[:, :, None] / jnp.maximum(1.0 - sij, 1e-10), 0.0)
    nent = jnp.sum(entrains, axis=2)                 # (ncol, nz) per i
    sij_stored = jnp.clip(jnp.where(valid_ij | (eye > 0), sij, 0.0),
                          0.0, 1.0)

    # detrain-at-level fallback when nothing entrains at level i
    no_ent = (nent == 0) & m_mask
    diag = eye > 0
    ment = jnp.where(no_ent[:, :, None] & diag, m[:, :, None], ment)
    qent = jnp.where(no_ent[:, :, None] & diag, qti[:, :, None], qent)
    uent = jnp.where(no_ent[:, :, None] & diag, u_nk, uent)
    vent = jnp.where(no_ent[:, :, None] & diag, v_nk, vent)
    elij = jnp.where(no_ent[:, :, None] & diag, clw[:, :, None], elij)
    sij_stored = jnp.where(no_ent[:, :, None] & diag, 1.0, sij_stored)

    # ---- normalize entrained fluxes (equal mixing probability) ---------
    qp1 = qti
    lvi = lv
    anum_s = h - hp - lvi * (qp1 - qs)
    denom_s = h - hp + lvi * (q - qp1)
    denom_s = jnp.where(jnp.abs(denom_s) < 0.01, 0.01, denom_s)
    scrit = anum_s / denom_s
    alt_s = qp1 - qs + scrit * (q - qp1)
    scrit = jnp.where(alt_s < 0.0, 1.0, scrit)
    scrit = jnp.maximum(scrit, 0.0)                  # (ncol, nz) per i

    sij_jm1 = jnp.pad(sij_stored, ((0, 0), (0, 0), (1, 0)))[:, :, :nz]
    sij_jp1 = jnp.pad(sij_stored, ((0, 0), (0, 0), (0, 1)))[:, :, 1:]
    cond_ent = (sij_stored > 0.0) & (sij_stored < 0.9) & valid_ij

    # sequential running SMIN over j for the j > i branch
    def smin_scan(carry, xs):
        smin = carry
        s_j, s_jp1, s_jm1, cond_j, is_above = xs
        # j > i branch
        smid_a = jnp.minimum(s_j, scrit)
        take = cond_j & is_above & (smid_a < smin) & (s_jp1 < smid_a)
        sjmax_a = jnp.where(take,
                            jnp.minimum(jnp.minimum(s_jp1, s_j), scrit),
                            smid_a)
        sjmin_a = jnp.where(take,
                            jnp.minimum(jnp.maximum(s_jm1, s_j), scrit),
                            smid_a)
        smin = jnp.where(take, smid_a, smin)
        # j <= i branch
        sjmax_b = jnp.maximum(s_jp1, scrit)
        smid_b = jnp.maximum(s_j, scrit)
        sjmin_b = jnp.maximum(jnp.where(ij_jj > 0, s_jm1, 0.0), scrit)
        smid = jnp.where(is_above, smid_a, smid_b)
        sjmax = jnp.where(is_above, sjmax_a, sjmax_b)
        sjmin = jnp.where(is_above, sjmin_a, sjmin_b)
        weight = jnp.where(cond_j,
                           jnp.abs(sjmax - smid) + jnp.abs(sjmin - smid),
                           0.0)
        return smin, weight

    # iterate j from low to high; arrays shaped (nz_j, ncol, nz_i)
    ij_jj = 0  # placeholder replaced per-iteration below
    weights = []
    smin = jnp.ones((ncol, nz))
    for j in range(nz):
        ij_jj = j
        s_j = sij_stored[:, :, j]
        s_jp1 = sij_jp1[:, :, j]
        s_jm1 = sij_jm1[:, :, j]
        cond_j = cond_ent[:, :, j]
        is_above = (j > jnp.arange(nz))[None, :]
        smin, w = smin_scan(smin, (s_j, s_jp1, s_jm1, cond_j, is_above))
        weights.append(w)
    weight = jnp.stack(weights, axis=2)              # (ncol, nz_i, nz_j)
    dph_j = dph[:, None, :]
    ment_w = ment * weight * dph_j
    asij = jnp.sum(weight * dph_j * cond_ent, axis=2)
    asij = jnp.maximum(asij, 1e-21)
    has_ent = nent > 0
    ment = jnp.where(cond_ent & has_ent[:, :, None],
                     ment_w / asij[:, :, None], ment)
    bsum = jnp.sum(jnp.where(valid_ij, ment, 0.0), axis=2)
    resort = has_ent & (bsum < 1e-18) & m_mask
    ment = jnp.where(resort[:, :, None] & diag, m[:, :, None], ment)
    qent = jnp.where(resort[:, :, None] & diag, qti[:, :, None], qent)
    uent = jnp.where(resort[:, :, None] & diag, u_nk, uent)
    vent = jnp.where(resort[:, :, None] & diag, v_nk, vent)
    elij = jnp.where(resort[:, :, None] & diag, clw[:, :, None], elij)

    # ---- precipitating downdraft (sequential descent) ------------------
    ep_inb = _take_level(ep, inb)
    skip_dd = ep_inb < 0.0001

    # detrained precipitation source at each level
    awat_ji = jnp.maximum(elij - (1.0 - ep[:, None, :]) * clw[:, None, :],
                          0.0)
    lower_tri = (ij_i < ij_j)                        # j-row contributions
    wdtrain_extra = jnp.sum(
        jnp.where(lower_tri, g * awat_ji * ment, 0.0), axis=1)
    wdtrain_all = g * ep * m * clw + wdtrain_extra   # (ncol, nz) per level

    coeff_lvl = jnp.where(T > 273.0, coeffr, coeffs)
    wt = jnp.where(T > 273.0, omtrain, omtsnow)

    # The downdraft recursion has several coupled carries; implement it
    # explicitly with a python loop over the (static) level axis — the
    # loop is unrolled by tracing, each iteration is vectorized over all
    # columns, and nz is small.
    water = [None] * (nz + 1)
    evap_l = [None] * nz
    mp_l = [None] * (nz + 1)
    qp_l = [None] * (nz + 1)
    up_l = [None] * (nz + 1)
    vp_l = [None] * (nz + 1)
    wt_l = [None] * (nz + 1)

    zero = jnp.zeros(ncol)
    water[nz] = zero
    mp_l[nz] = zero
    wt_l[nz] = jnp.full((ncol,), omtsnow)
    qp_l[nz] = q[:, nz - 1]
    up_l[nz] = u[:, nz - 1]
    vp_l[nz] = v[:, nz - 1]
    jtt_p = p[:, 0] * 0 + 1.0   # pressure at jtt (init irrelevant)
    jtt_mp = zero
    jtt_set = jnp.zeros(ncol, dtype=bool)

    for i in range(nz - 1, -1, -1):
        in_dd = (i <= inb) & active & ~skip_dd
        wt_i = wt[:, i]
        coeff_i = coeff_lvl[:, i]
        qsm = 0.5 * (q[:, i] + qp_l[i + 1])
        afac = jnp.maximum(
            coeff_i * ph[:, i] * (qs[:, i] - qsm)
            / (1.0e4 + 2.0e3 * ph[:, i] * qs[:, i]), 0.0)
        sigt = jnp.clip(sigp[:, i], 0.0, 1.0)
        b6 = 100.0 * dph[:, i] * sigt * afac / wt_i
        c6 = (water[i + 1] * wt_l[i + 1] + wdtrain_all[:, i] / sigd) / wt_i
        revap = 0.5 * (-b6 + jnp.sqrt(jnp.maximum(
            b6 * b6 + 4.0 * c6, 0.0)))
        evap_i = jnp.where(in_dd, sigt * afac * revap, 0.0)
        water_i = jnp.where(in_dd, revap * revap, 0.0)

        if i > 0:
            dhdp = jnp.maximum(
                (h[:, i] - h[:, i - 1])
                / jnp.maximum(p[:, i - 1] - p[:, i], 1e-10), 10.0)
            mp_i = jnp.maximum(
                100.0 * ginv * lv[:, i] * sigd * evap_i / dhdp, 0.0)
            fac = 20.0 / jnp.maximum(dph[:, i - 1], 1e-10)
            mp_i = (fac * mp_l[i + 1] + mp_i) / (1.0 + fac)
            near_sfc = p[:, i] > 0.949 * p[:, 0]
            # track jtt: highest level (first reached descending) with
            # the near-surface condition; freeze its (p, mp)
            newly = near_sfc & ~jtt_set & in_dd
            jtt_p = jnp.where(newly, p[:, i], jtt_p)
            jtt_mp = jnp.where(newly, mp_i, jtt_mp)
            jtt_set = jtt_set | newly
            mp_i = jnp.where(near_sfc & jtt_set,
                             jtt_mp * (p[:, 0] - p[:, i])
                             / jnp.maximum(p[:, 0] - jtt_p, 1e-10),
                             mp_i)
            mp_i = jnp.where(in_dd, mp_i, 0.0)
        else:
            mp_i = zero
        mp_l[i] = mp_i

        # downdraft mixing ratio
        is_inb = jnp.asarray(i)[None] == inb
        qstm = qs[:, max(i - 1, 0)] if i > 0 else qs[:, 0]
        grow = mp_i > mp_l[i + 1]
        rat = mp_l[i + 1] / jnp.maximum(mp_i, 1e-30)
        qp_grow = (qp_l[i + 1] * rat + q[:, i] * (1.0 - rat)
                   + 100.0 * ginv * sigd * dph[:, i]
                   * (evap_i / jnp.maximum(mp_i, 1e-30)))
        up_grow = up_l[i + 1] * rat + u[:, i] * (1.0 - rat)
        vp_grow = vp_l[i + 1] * rat + v[:, i] * (1.0 - rat)
        ip1 = min(i + 1, nz - 1)
        qp_desc = ((gz[:, ip1] - gz[:, i]
                    + qp_l[i + 1] * (lv[:, ip1] + T[:, ip1] * (cl - cpd))
                    + cpd * (T[:, ip1] - T[:, i]))
                   / (lv[:, i] + T[:, i] * (cl - cpd)))
        has_mp_up = mp_l[i + 1] > 0.0
        qp_prev = q[:, i - 1] if i > 0 else q[:, 0]
        qp_i = jnp.where(grow, qp_grow,
                         jnp.where(has_mp_up, qp_desc, qp_prev))
        up_i = jnp.where(grow, up_grow,
                         jnp.where(has_mp_up, up_l[i + 1],
                                   u[:, i - 1] if i > 0 else u[:, 0]))
        vp_i = jnp.where(grow, vp_grow,
                         jnp.where(has_mp_up, vp_l[i + 1],
                                   v[:, i - 1] if i > 0 else v[:, 0]))
        qp_i = jnp.clip(qp_i, 0.0, qstm)
        # at i == inb the mixing-ratio update is skipped (GOTO 400)
        default_qp = q[:, i - 1] if i > 0 else q[:, 0]
        default_up = u[:, i - 1] if i > 0 else u[:, 0]
        default_vp = v[:, i - 1] if i > 0 else v[:, 0]
        qp_l[i] = jnp.where(in_dd & ~is_inb, qp_i, default_qp)
        up_l[i] = jnp.where(in_dd & ~is_inb, up_i, default_up)
        vp_l[i] = jnp.where(in_dd & ~is_inb, vp_i, default_vp)
        water[i] = water_i
        evap_l[i] = evap_i
        wt_l[i] = wt_i

    water_arr = jnp.stack(water[:nz], axis=1)
    evap_arr = jnp.stack(evap_l, axis=1)
    mp_arr = jnp.stack(mp_l[:nz + 1], axis=1)
    qp_arr = jnp.stack(qp_l[:nz + 1], axis=1)
    up_arr = jnp.stack(up_l[:nz + 1], axis=1)
    vp_arr = jnp.stack(vp_l[:nz + 1], axis=1)
    wt_arr = jnp.stack(wt_l[:nz + 1], axis=1)

    precip = jnp.where(
        active & ~skip_dd,
        wt_arr[:, 0] * sigd * water_arr[:, 0] * 3600.0 * 24000.0
        / (rowl * g),
        0.0)

    # ---- downdraft scales ----------------------------------------------
    mp_icb = _take_level(mp_arr[:, :nz], icb_s)
    T_icb = _take_level(T, icb_s)
    p_icb_ = _take_level(p, icb_s)
    wd = beta * jnp.abs(mp_icb) * 0.01 * rd * T_icb / (sigd * p_icb_)
    qprime = 0.5 * (qp_arr[:, 0] - q[:, 0])
    tprime = lv0 * qprime / cpd

    # ---- tendencies ----------------------------------------------------
    delti = 1.0 / dt
    iflag = jnp.where(active, 1, 0)

    # lowest level
    dpinv0 = 0.01 / dph[:, 0]
    am_mask = (k >= 1) & (k <= inb[:, None])
    am = jnp.where(nk_s == 0,
                   jnp.sum(jnp.where(am_mask, m, 0.0), axis=1), 0.0)
    cfl1 = (2.0 * g * dpinv0 * am) >= delti
    ft0 = (g * dpinv0 * am * (T[:, 1] - T[:, 0]
                              + (gz[:, 1] - gz[:, 0]) / cpn[:, 0])
           - lvcp[:, 0] * sigd * evap_arr[:, 0]
           + sigd * wt_arr[:, 1] * (cl - cpd) * water_arr[:, 1]
           * (T[:, 1] - T[:, 0]) * dpinv0 / cpn[:, 0])
    fq0 = (g * mp_arr[:, 1] * (qp_arr[:, 1] - q[:, 0]) * dpinv0
           + sigd * evap_arr[:, 0]
           + g * am * (q[:, 1] - q[:, 0]) * dpinv0)
    fu0 = g * dpinv0 * (mp_arr[:, 1] * (up_arr[:, 1] - u[:, 0])
                        + am * (u[:, 1] - u[:, 0]))
    fv0 = g * dpinv0 * (mp_arr[:, 1] * (vp_arr[:, 1] - v[:, 0])
                        + am * (v[:, 1] - v[:, 0]))
    j_mask0 = (k >= 1) & (k <= inb[:, None])
    ment_j0 = ment[:, :, 0]
    fq0 = fq0 + g * dpinv0 * jnp.sum(
        jnp.where(j_mask0, ment_j0 * (qent[:, :, 0] - q[:, 0:1]), 0.0),
        axis=1)
    fu0 = fu0 + g * dpinv0 * jnp.sum(
        jnp.where(j_mask0, ment_j0 * (uent[:, :, 0] - u[:, 0:1]), 0.0),
        axis=1)
    fv0 = fv0 + g * dpinv0 * jnp.sum(
        jnp.where(j_mask0, ment_j0 * (vent[:, :, 0] - v[:, 0:1]), 0.0),
        axis=1)

    # levels 1..inb (0-based)
    dpinv = 0.01 / dph
    cpinv = 1.0 / cpn
    # amp1(i) = sum_{k=i+1..inb+1} m(k) [if i>=nk]
    #         + sum_{k<=i} sum_{j=i+1..inb+1} ment(k,j)
    inb_p1 = jnp.minimum(inb + 1, nz - 1)
    m_cum_rev = jnp.cumsum(m[:, ::-1], axis=1)[:, ::-1]  # sum_{k>=i} m
    m_above = jnp.concatenate(
        [m_cum_rev[:, 1:], jnp.zeros((ncol, 1))], axis=1)
    # note: m is zero above inb so sum_{k=i+1..inb+1} = sum_{k>i}
    amp1_m = jnp.where(k >= nk_s[:, None], m_above, 0.0)
    # ment partial sums via one matmul:
    # amp1_ment[c,i] = sum_{k<=i} sum_{j>i, j<=inb+1} ment[c,k,j]
    jj = jnp.arange(nz)[None, None, :]
    ii = jnp.arange(nz)[None, :, None]
    ment_cols = jnp.where(jj <= inb_p1[:, None, None], ment, 0.0)
    jj_ = np.arange(nz)
    W_amp = ((jj_[:, None, None] <= jj_[None, None, :])
             & (jj_[None, :, None] > jj_[None, None, :]))
    W_amp = jnp.asarray(W_amp.reshape(nz * nz, nz), dtype=ment.dtype)
    amp1_ment = jnp.matmul(ment_cols.reshape(ncol, nz * nz), W_amp,
                           precision=dot_precision('physics'))
    amp1 = amp1_m + amp1_ment

    # ad(i) = sum_{kk<=i-1} sum_{jrow=i..inb} ment[jrow, kk], via cumsums:
    # prefix over kk (strictly below i), mask jrow<=inb, suffix over jrow,
    # then read the diagonal (jrow = i)
    jrow = jnp.arange(nz)[None, :, None]
    # one masked read of ment + a single (nz^2 x nz) matmul (one dense product):
    # ad[c,i] = sum_{j,k} ment_rows[c,j,k] * (j >= i) * (k < i)
    ment_rows = jnp.where(jrow <= inb[:, None, None], ment, 0.0)
    jj_ = np.arange(nz)
    W_ad = ((jj_[:, None, None] >= jj_[None, None, :])
            & (jj_[None, :, None] < jj_[None, None, :]))
    W_ad = jnp.asarray(W_ad.reshape(nz * nz, nz), dtype=ment.dtype)
    ad = jnp.matmul(ment_rows.reshape(ncol, nz * nz), W_ad,
                    precision=dot_precision('physics'))

    cfl = (2.0 * g * dpinv * amp1) >= delti
    T_up = jnp.concatenate([T[:, 1:], T[:, -1:]], axis=1)
    T_dn = jnp.concatenate([T[:, :1], T[:, :-1]], axis=1)
    q_up = jnp.concatenate([q[:, 1:], q[:, -1:]], axis=1)
    q_dn = jnp.concatenate([q[:, :1], q[:, :-1]], axis=1)
    u_up = jnp.concatenate([u[:, 1:], u[:, -1:]], axis=1)
    u_dn = jnp.concatenate([u[:, :1], u[:, :-1]], axis=1)
    v_up = jnp.concatenate([v[:, 1:], v[:, -1:]], axis=1)
    v_dn = jnp.concatenate([v[:, :1], v[:, :-1]], axis=1)
    gz_up = jnp.concatenate([gz[:, 1:], gz[:, -1:]], axis=1)
    gz_dn = jnp.concatenate([gz[:, :1], gz[:, :-1]], axis=1)

    ment_diag = jnp.einsum('cii->ci', ment)
    qent_diag = jnp.einsum('cii->ci', qent)
    water_up_arr = jnp.concatenate(
        [water_arr[:, 1:], jnp.zeros((ncol, 1))], axis=1)
    wt_up_arr = wt_arr[:, 1:]
    mp_up_arr = mp_arr[:, 1:]
    qp_up_arr = qp_arr[:, 1:]
    up_up_arr = up_arr[:, 1:]
    vp_up_arr = vp_arr[:, 1:]
    mp_here = mp_arr[:, :nz]
    qp_here = qp_arr[:, :nz]
    up_here = up_arr[:, :nz]
    vp_here = vp_arr[:, :nz]

    ft = (g * dpinv * (amp1 * (T_up - T + (gz_up - gz) * cpinv)
                       - ad * (T - T_dn + (gz - gz_dn) * cpinv))
          - sigd * lvcp * evap_arr
          + g * dpinv * ment_diag * (hp - h + T * (cpv - cpd)
                                     * (q - qent_diag)) * cpinv
          + sigd * wt_up_arr * (cl - cpd) * water_up_arr
          * (T_up - T) * dpinv * cpinv)
    fq = g * dpinv * (amp1 * (q_up - q) - ad * (q - q_dn))
    fu = g * dpinv * (amp1 * (u_up - u) - ad * (u - u_dn))
    fv = g * dpinv * (amp1 * (v_up - v) - ad * (v - v_dn))

    # entrainment/detrainment exchanges, sum over rows kk of ment[kk, i].
    # ment rows above inb are zero, so the (kk < i) | (i <= kk <= inb)
    # union reduces to a plain sum over kk; the detrained-water correction
    # applies only to rows kk < i (one static lower-triangular matvec).
    awat_col = jnp.maximum(
        elij - (1.0 - ep[:, None, :]) * clw[:, None, :], 0.0)
    jlt = jnp.asarray(
        (np.arange(nz)[:, None] < np.arange(nz)[None, :]),
        dtype=ment.dtype)
    fq = fq + g * dpinv * (
        jnp.sum(ment * (qent - q[:, None, :]), axis=1)
        - jnp.einsum('cki,ki->ci', ment * awat_col, jlt,
                     precision=dot_precision('physics')))
    fu = fu + g * dpinv * jnp.sum(ment * (uent - u[:, None, :]), axis=1)
    fv = fv + g * dpinv * jnp.sum(ment * (vent - v[:, None, :]), axis=1)

    fq = fq + sigd * evap_arr + g * dpinv * (
        mp_up_arr * (qp_up_arr - q)
        - mp_here * (qp_here - q_dn))
    fu = fu + g * dpinv * (mp_up_arr * (up_up_arr - u)
                           - mp_here * (up_here - u_dn))
    fv = fv + g * dpinv * (mp_up_arr * (vp_up_arr - v)
                           - mp_here * (vp_here - v_dn))

    # select the lowest level forms
    ft = ft.at[:, 0].set(ft0)
    fq = fq.at[:, 0].set(fq0)
    fu = fu.at[:, 0].set(fu0)
    fv = fv.at[:, 0].set(fv0)

    # zero outside [0, inb]
    lev_mask = k <= inb[:, None]
    ft = jnp.where(lev_mask, ft, 0.0)
    fq = jnp.where(lev_mask, fq, 0.0)
    fu = jnp.where(lev_mask, fu, 0.0)
    fv = jnp.where(lev_mask, fv, 0.0)

    # ---- spread tendencies at the convection top by frac ---------------
    one_hot_inb = (k == inb[:, None]).astype(T.dtype)
    one_hot_inbm1 = (k == (inb - 1)[:, None]).astype(T.dtype)
    dph_inb = _take_level(dph, inb)
    dph_inbm1 = _take_level(dph, jnp.maximum(inb - 1, 0))
    ratio = dph_inb / jnp.maximum(dph_inbm1, 1e-10)
    lv_inb = _take_level(lv, inb)
    lv_inbm1 = _take_level(lv, jnp.maximum(inb - 1, 0))
    cpn_inb = _take_level(cpn, inb)
    cpn_inbm1 = _take_level(cpn, jnp.maximum(inb - 1, 0))

    def spread(f, extra_ratio):
        f_inb = jnp.sum(f * one_hot_inb, axis=1)
        shift = frac * f_inb * ratio * extra_ratio
        return (f * (1.0 - frac[:, None] * one_hot_inb)
                + shift[:, None] * one_hot_inbm1)

    fq = spread(fq, lv_inb / lv_inbm1)
    ft = spread(ft, cpn_inb / cpn_inbm1)
    fu = spread(fu, jnp.ones(ncol))
    fv = spread(fv, jnp.ones(ncol))

    # ---- exact enthalpy / momentum conservation fix ---------------------
    cons_mask = (k <= inb[:, None]).astype(T.dtype)
    ph_inb1 = jnp.take_along_axis(ph, (inb + 1)[:, None], axis=1)[:, 0]
    norm = 1.0 / jnp.maximum(ph[:, 0] - ph_inb1, 1e-10)
    ents = jnp.sum((cpn * ft + lv * fq) * dph * cons_mask, axis=1) * norm
    uav = jnp.sum(fu * dph * cons_mask, axis=1) * norm
    vav = jnp.sum(fv * dph * cons_mask, axis=1) * norm
    ft = ft - cons_mask * ents[:, None] / cpn
    fu = (1.0 - cu) * (fu - uav[:, None]) * cons_mask \
        + fu * (1.0 - cons_mask)
    fv = (1.0 - cu) * (fv - vav[:, None]) * cons_mask \
        + fv * (1.0 - cons_mask)

    # ---- final masking for inactive columns -----------------------------
    act = active[:, None]
    zeros2 = jnp.zeros_like(T)
    ft = jnp.where(act, ft, 0.0)
    fq = jnp.where(act, fq, 0.0)
    fu = jnp.where(act, fu, 0.0)
    fv = jnp.where(act, fv, 0.0)
    precip = jnp.where(active, precip, 0.0)
    wd = jnp.where(active & ~skip_dd, wd, 0.0)
    tprime = jnp.where(active & ~skip_dd, tprime, 0.0)
    qprime = jnp.where(active & ~skip_dd, qprime, 0.0)
    cape_out = jnp.where(active, cape, 0.0)
    cbmf_out = jnp.where(no_conv0 | no_conv2 | no_conv3, 0.0,
                         jnp.where(stable_skip, cbmf_in, cbmf))
    any_cfl = jnp.any(jnp.where(lev_mask, cfl, False), axis=1) | cfl1
    iflag = jnp.where(active & any_cfl, 4, iflag)

    return {'ft': ft, 'fq': fq, 'fu': fu, 'fv': fv,
            'precip': precip, 'wd': wd, 'tprime': tprime,
            'qprime': qprime, 'cbmf': cbmf_out, 'cape': cape_out,
            'iflag': iflag}


class EmanuelConvection(ImplicitTendencyComponent):
    """Emanuel & Zivkovic-Rothman (1999) convection scheme."""

    input_properties = {
        'air_temperature': {'dims': ['*', 'mid_levels'], 'units': 'degK'},
        'specific_humidity': {'dims': ['*', 'mid_levels'],
                              'units': 'kg/kg'},
        'eastward_wind': {'dims': ['*', 'mid_levels'], 'units': 'm s^-1'},
        'northward_wind': {'dims': ['*', 'mid_levels'],
                           'units': 'm s^-1'},
        'air_pressure': {'dims': ['*', 'mid_levels'], 'units': 'mbar'},
        'air_pressure_on_interface_levels': {
            'dims': ['*', 'interface_levels'], 'units': 'mbar'},
        'cloud_base_mass_flux': {'dims': ['*'], 'units': 'kg m^-2 s^-1'},
    }

    diagnostic_properties = {
        'convective_state': {'dims': ['*'], 'units': 'dimensionless'},
        'convective_precipitation_rate': {'dims': ['*'],
                                          'units': 'mm day^-1'},
        'convective_downdraft_velocity_scale': {'dims': ['*'],
                                                'units': 'm s^-1'},
        'convective_downdraft_temperature_scale': {'dims': ['*'],
                                                   'units': 'degK'},
        'convective_downdraft_specific_humidity_scale': {
            'dims': ['*'], 'units': 'kg/kg'},
        'cloud_base_mass_flux': {'dims': ['*'], 'units': 'kg m^-2 s^-1'},
        'atmosphere_convective_available_potential_energy': {
            'dims': ['*'], 'units': 'J kg^-1'},
        'air_temperature_tendency_from_convection': {
            'dims': ['*', 'mid_levels'], 'units': 'degK day^-1'},
    }

    tendency_properties = {
        'air_temperature': {'units': 'degK s^-1'},
        'specific_humidity': {'units': 'kg/kg s^-1'},
        'eastward_wind': {'units': 'm s^-2'},
        'northward_wind': {'units': 'm s^-2'},
    }

    def __init__(self,
                 minimum_convecting_layer=1,
                 autoconversion_water_content_threshold=0.0011,
                 autoconversion_temperature_threshold=-55,
                 entrainment_mixing_coefficient=1.5,
                 downdraft_area_fraction=0.05,
                 precipitation_fraction_outside_cloud=0.12,
                 speed_water_droplets=50.0,
                 speed_snow=5.5,
                 rain_evaporation_coefficient=1.0,
                 snow_evaporation_coefficient=0.8,
                 convective_momentum_transfer_coefficient=0.7,
                 downdraft_surface_velocity_coefficient=10.0,
                 convection_bouyancy_threshold=0.9,
                 mass_flux_relaxation_rate=0.1,
                 mass_flux_damping_rate=0.1,
                 reference_mass_flux_timescale=300.,
                 **kwargs):
        if not 0 <= convective_momentum_transfer_coefficient <= 1:
            raise ValueError(
                'Momentum transfer coefficient must be between 0 and 1.')
        if not 0 <= downdraft_area_fraction <= 1:
            raise ValueError(
                'Downdraft fraction must be between 0 and 1.')
        if not 0 <= precipitation_fraction_outside_cloud <= 1:
            raise ValueError(
                'Outside cloud precipitation fraction must be between '
                '0 and 1.')
        self._options = dict(
            minorig=minimum_convecting_layer - 1,
            elcrit=autoconversion_water_content_threshold,
            tlcrit=autoconversion_temperature_threshold,
            entp=entrainment_mixing_coefficient,
            sigd=downdraft_area_fraction,
            sigs=precipitation_fraction_outside_cloud,
            omtrain=speed_water_droplets,
            omtsnow=speed_snow,
            coeffr=rain_evaporation_coefficient,
            coeffs=snow_evaporation_coefficient,
            cu=convective_momentum_transfer_coefficient,
            beta=downdraft_surface_velocity_coefficient,
            dtmax=convection_bouyancy_threshold,
            alpha=mass_flux_relaxation_rate,
            damp=mass_flux_damping_rate,
            delt0=reference_mass_flux_timescale,
        )
        super().__init__(**kwargs)

    def array_call(self, raw_state, timestep):
        dt = timestep_seconds(timestep)
        params = dict(self._options)
        params['g'] = get_constant('gravitational_acceleration', 'm/s^2')
        params['cpd'] = get_constant(
            'heat_capacity_of_dry_air_at_constant_pressure', 'J/kg/degK')
        params['cpv'] = get_constant('heat_capacity_of_vapor_phase',
                                     'J/kg/degK')
        params['rd'] = get_constant('gas_constant_of_dry_air', 'J/kg/degK')
        params['rv'] = get_constant('gas_constant_of_vapor_phase',
                                    'J/kg/degK')
        params['lv0'] = get_constant('latent_heat_of_condensation', 'J/kg')
        params['rowl'] = get_constant('density_of_liquid_phase', 'kg/m^3')
        params['cl'] = get_constant('specific_enthalpy_of_vapor_phase',
                                    'J/kg')

        T = jnp.asarray(raw_state['air_temperature'])
        q = jnp.asarray(raw_state['specific_humidity'])
        u = jnp.asarray(raw_state['eastward_wind'])
        v = jnp.asarray(raw_state['northward_wind'])
        p = jnp.asarray(raw_state['air_pressure'])
        ph = jnp.asarray(raw_state['air_pressure_on_interface_levels'])
        cbmf = jnp.asarray(raw_state['cloud_base_mass_flux'])

        ncol, nz = T.shape
        nl = nz - 3
        # reference quirk: bolton_q_sat called with (Cpd, Cpv) in place of
        # the gas constants (component.py:274-278) — reproduced for parity
        q_sat = bolton_q_sat(T, p * 100.0, params['cpd'], params['cpv'])

        out = emanuel_convect(T, q, q_sat, u, v, p, ph, cbmf, dt, nl,
                              params)

        tendencies = {
            'air_temperature': out['ft'],
            'specific_humidity': out['fq'],
            'eastward_wind': out['fu'],
            'northward_wind': out['fv'],
        }
        diagnostics = {
            'convective_state': out['iflag'].astype(jnp.float64)
            if T.dtype == jnp.float64 else out['iflag'].astype(T.dtype),
            'convective_precipitation_rate': out['precip'],
            'convective_downdraft_velocity_scale': out['wd'],
            'convective_downdraft_temperature_scale': out['tprime'],
            'convective_downdraft_specific_humidity_scale': out['qprime'],
            'cloud_base_mass_flux': out['cbmf'],
            'atmosphere_convective_available_potential_energy':
                out['cape'],
            'air_temperature_tendency_from_convection':
                out['ft'] * 86400.0,
        }
        return tendencies, diagnostics


class EmanuelConvectionPython(EmanuelConvection):
    """Alias for API parity with the reference's pure-Python backend.

    The reference ships the same Emanuel scheme twice: the Fortran-backed
    ``EmanuelConvection`` and a pure-Python ``EmanuelConvectionPython``
    (emanuel/pure_python_v3.py) for environments without compiled
    extensions.  climt_tpu's ``EmanuelConvection`` is already a
    from-scratch JAX implementation — it IS the no-native-extensions
    backend — so the alias exposes the same component under both names.
    """
