"""RRTMG-SW 112-g-point correlated-k radiative transfer in JAX.

Faithful JAX reimplementation of the reference's shortwave scheme
(/root/reference/climt/_lib/rrtmg_sw/): the per-column Fortran loops become
whole-grid vectorized gathers and scans; the k-coefficient tables live as
constant device arrays (climt_tpu/data/rrtmg_sw_kdist.npz, extracted by
tools/parse_rrtmg_sw_data.py).

Algorithm sources (behavior, not code, re-expressed in JAX):
- setcoef_sw: pressure/temperature interpolation indices and continuum
  factors (rrtmg_sw_setcoef.f90:50-320).
- taumol_sw: per-band g-point optical depths, bands 16-29
  (rrtmg_sw_taumol.f90:275-1790).  The two-key-species "binary species
  parameter" eta interpolation and the single-species interpolation are
  unified into one 8-point gather with band-static offsets; below/above
  tropopause branches become a mask-selected gather into the concatenated
  [absa; absb] table, so each band costs one fused gather pass.
- cldprop_sw: cloud optical properties per band for the direct-input and
  liquid+ice pathways (rrtmg_sw_cldprop.f90).
- spcvrt_sw / reftra_sw / vrtqdr_sw: delta-scaled two-stream (Meador-
  Weaver kmodts=2) with the adding method, clear+total sky
  (rrtmg_sw_spcvrt.f90, rrtmg_sw_reftra.f90, rrtmg_sw_vrtqdr.f90).
- Solar variability options isolvar -1..3 (NRLSSI2) and earth-sun
  distance handling (rrtmg_sw_rad.nomcica.f90:1196-1420).

The Fortran's Pade-lookup exponential table (rrtmg_sw_init.f90:100-123)
is reproduced exactly so golden outputs match to interpolation precision.

Layout convention: layers are bottom-up (index 0 = lowest), columns are
the trailing axis, matching the component state arrays (nz, ncol).
"""

from __future__ import annotations

import functools
import os

import jax.numpy as jnp
import numpy as np
from jax import lax

from .interp import lin_rows, mix_rows, mix_rows_windowed
from ...ops.precision import dot_precision

_DATA = os.path.join(os.path.dirname(__file__), '..', '..', 'data',
                     'rrtmg_sw_kdist.npz')

NBANDS = 14
NGPT = 112
NG = [6, 12, 8, 8, 10, 10, 2, 10, 8, 6, 6, 8, 6, 12]
NGS = np.concatenate([[0], np.cumsum(NG)])          # offsets into 112
NSPA = [9, 9, 9, 9, 1, 9, 9, 1, 9, 1, 0, 1, 9, 1]
NSPB = [1, 5, 1, 1, 1, 5, 1, 0, 1, 0, 0, 1, 5, 1]
# band index (0-based) for each of the 112 g-points
NGB = np.concatenate([np.full(n, b) for b, n in enumerate(NG)])
# band wavenumber edges (rrtmg_sw_init.f90:193-196); band order 16..29
WAVENUM2 = np.array([3250., 4000., 4650., 5150., 6150., 7700., 8050.,
                     12850., 16000., 22650., 29000., 38000., 50000.,
                     2600.])

ONEMINUS = 1.0 - 1.0e-6
# NRLSSI2 integration constants (rrtmg_sw_rad.nomcica.f90:1100-1113)
IINT, FINT, SINT = 1360.37, 0.996047, -0.511590
FOFFSET, SOFFSET = 0.14959542, 0.00066696
SVAR_F_AVG, SVAR_S_AVG = 0.1568113, 909.21910
SVAR_CPRIM = FINT + SINT + IINT
RRSW_SCON = 1.36822e+03                     # parrrsw.f90:115
AMD, AMW = 28.9660, 18.0160                 # molecular weights (g/mol)

# exponential transmittance lookup table (rrtmg_sw_init.f90:100-123)
NTBL, OD_LO, PADE, EXPEPS = 10000, 0.06, 0.278, 1.0e-20
BPADE = 1.0 / PADE
_tfn = np.arange(1, NTBL) / NTBL
EXP_TBL = np.concatenate(
    [[1.0], np.maximum(np.exp(-BPADE * _tfn / (1.0 - _tfn)), EXPEPS),
     [EXPEPS]])

# Band definitions, bands 16..29 in order.  Keys:
#   lo/up: (species,) or (sp1, sp2, strrat[, eta]) key-species spec, or
#          None (no gaseous key term in that regime)
#   self/for_lo/for_up: water-vapor continuum terms present
#   extra: additive (column_amount, table, regime) minor-absorber terms
#   sflux: ('lo'|'up', eta_count) solar-source location & interpolation
#   layreffr: reference level for the solar source (Fortran 1-based jp)
#   rayl: 'c' scalar, 'pg' per-g-point, 'b24' eta-interpolated lower
#   kscale_lo: multiplier on the lower key-species interpolation term
#   up_col_scale: multiplier on the upper key column amount (band 22)
#   o2cont: O2 continuum additive term (band 22)
BANDS = [
    dict(num=16, lo=('h2o', 'ch4', 252.131), up=('ch4',),
         self_lo=True, for_lo=True, for_up=False,
         sflux=('up', 0), layreffr=18, rayl='c'),
    dict(num=17, lo=('h2o', 'co2', 0.364641), up=('h2o', 'co2', 0.364641),
         self_lo=True, for_lo=True, for_up=True,
         sflux=('up', 4), layreffr=30, rayl='c'),
    dict(num=18, lo=('h2o', 'ch4', 38.9589), up=('ch4',),
         self_lo=True, for_lo=True, for_up=False,
         sflux=('lo', 8), layreffr=6, rayl='c'),
    dict(num=19, lo=('h2o', 'co2', 5.49281), up=('co2',),
         self_lo=True, for_lo=True, for_up=False,
         sflux=('lo', 8), layreffr=3, rayl='c'),
    dict(num=20, lo=('h2o',), up=('h2o',),
         self_lo=True, for_lo=True, for_up=True,
         extra=[('ch4', 'absch4', 'both')],
         sflux=('lo', 0), layreffr=3, rayl='c'),
    dict(num=21, lo=('h2o', 'co2', 0.0045321), up=('h2o', 'co2', 0.0045321),
         self_lo=True, for_lo=True, for_up=True,
         sflux=('lo', 8), layreffr=8, rayl='c'),
    dict(num=22, lo=('h2o', 'o2', 1.6 * 0.022708), up=('o2',),
         self_lo=True, for_lo=True, for_up=False, up_col_scale=1.6,
         o2cont=True, sflux=('lo', 8), layreffr=2, rayl='c'),
    dict(num=23, lo=('h2o',), up=None,
         self_lo=True, for_lo=True, for_up=False, kscale_lo=1.029,
         sflux=('lo', 0), layreffr=6, rayl='pg'),
    dict(num=24, lo=('h2o', 'o2', 0.124692), up=('o2',),
         self_lo=True, for_lo=True, for_up=False,
         extra=[('o3', 'abso3a', 'lo'), ('o3', 'abso3b', 'up')],
         sflux=('lo', 8), layreffr=1, rayl='b24'),
    dict(num=25, lo=('h2o',), up=None,
         self_lo=False, for_lo=False, for_up=False,
         extra=[('o3', 'abso3a', 'lo'), ('o3', 'abso3b', 'up')],
         sflux=('lo', 0), layreffr=2, rayl='pg'),
    dict(num=26, lo=None, up=None,
         self_lo=False, for_lo=False, for_up=False,
         sflux=('lo', 0), layreffr=0, rayl='pg'),
    dict(num=27, lo=('o3',), up=('o3',),
         self_lo=False, for_lo=False, for_up=False,
         sflux=('up', 0), layreffr=32, rayl='pg',
         sflux_scale=50.15 / 48.37),
    dict(num=28, lo=('o3', 'o2', 6.67029e-07), up=('o3', 'o2', 6.67029e-07),
         self_lo=False, for_lo=False, for_up=False,
         sflux=('up', 4), layreffr=58, rayl='c'),
    dict(num=29, lo=('h2o',), up=('co2',),
         self_lo=True, for_lo=True, for_up=False,
         extra=[('co2', 'absco2', 'lo'), ('h2o', 'absh2o', 'up')],
         sflux=('up', 0), layreffr=49, rayl='c'),
]


@functools.lru_cache()
def load_tables():
    """Load the k-distribution npz into plain numpy (device-put lazily)."""
    d = dict(np.load(_DATA))
    d['exp_tbl'] = EXP_TBL
    return d


def _trunc_int(x):
    return jnp.trunc(x).astype(jnp.int32)


def setcoef_sw(pavel, tavel, coldry, wkl):
    """Interpolation indices/fractions and column amounts.

    Vectorized over (nz, ncol); mirrors rrtmg_sw_setcoef.f90:50-320 with
    the tropopause branch (plog <= 4.56) handled by masks.

    Args:
      pavel: layer pressure (mb), (nz, ncol), bottom-up.
      tavel: layer temperature (K).
      coldry: dry-air column density (molec/cm^2).
      wkl: dict of molecular amounts (molec/cm^2) for h2o,co2,o3,n2o,ch4,o2.
    Returns dict of setcoef outputs (0-based indices).
    """
    t = load_tables()
    preflog = jnp.asarray(t['preflog'], pavel.dtype)
    tref = jnp.asarray(t['tref'], pavel.dtype)
    stpfac = 296.0 / 1013.0

    plog = jnp.log(pavel)
    jp = jnp.clip(_trunc_int(36.0 - 5.0 * (plog + 0.04)), 1, 58)  # 1-based
    jp0 = jp - 1
    fp = 5.0 * (preflog[jp0] - plog)

    def t_index(jpx):
        jt = jnp.clip(_trunc_int(3.0 + (tavel - tref[jpx]) / 15.0), 1, 4)
        ft = (tavel - tref[jpx]) / 15.0 - (jt - 3)
        return jt - 1, ft                               # 0-based

    jt0, ft = t_index(jp0)
    jt10, ft1 = t_index(jp0 + 1)

    trop = plog > 4.56
    water = wkl['h2o'] / coldry
    scalefac = pavel * stpfac / tavel
    forfac = scalefac / (1.0 + water)

    fac_lo = (332.0 - tavel) / 36.0
    indfor_lo = jnp.clip(_trunc_int(fac_lo), 1, 2)
    forfrac_lo = fac_lo - indfor_lo
    fac_up = (tavel - 188.0) / 36.0
    indfor = jnp.where(trop, indfor_lo, 3) - 1          # 0-based
    forfrac = jnp.where(trop, forfrac_lo, fac_up - 1.0)

    fac_s = (tavel - 188.0) / 7.2
    indself = jnp.clip(_trunc_int(fac_s) - 7, 1, 9) - 1  # 0-based
    selffrac = fac_s - (indself + 1 + 7)
    selffac = jnp.where(trop, water * forfac, 0.0)
    selffrac = jnp.where(trop, selffrac, 0.0)
    indself = jnp.where(trop, indself, 0)

    cols = {}
    for gas in ('h2o', 'co2', 'o3', 'n2o', 'ch4', 'o2'):
        c = 1.0e-20 * wkl[gas]
        if gas != 'h2o' and gas != 'o3':
            c = jnp.where(c == 0.0, 1.0e-32 * coldry, c)
        elif gas == 'o3':
            c = jnp.where(c == 0.0, 0.0, c)  # no floor for o3 in setcoef
        cols['col' + gas] = c
    # Fortran floors co2,n2o,ch4,o2 only; h2o/o3 keep zeros
    cols['colmol'] = 1.0e-20 * coldry + cols['colh2o']

    compfp = 1.0 - fp
    return dict(
        trop=trop, jp=jp, jp0=jp0, jt0=jt0, jt10=jt10,
        fac00=compfp * (1.0 - ft), fac10=compfp * ft,
        fac01=fp * (1.0 - ft1), fac11=fp * ft1,
        selffac=selffac, selffrac=selffrac, indself=indself,
        forfac=forfac, forfrac=forfrac, indfor=indfor, **cols)


def _eta(specparm, n_eta, dtype):
    specmult = n_eta * jnp.minimum(specparm, ONEMINUS)
    js0 = _trunc_int(specmult)
    fs = specmult - js0
    return js0, fs.astype(dtype)


def _key_spec(spec, cs):
    """(speccomb, specparm) for a key-species tuple."""
    if spec is None:
        return None, None
    c1 = cs['col' + spec[0]]
    if len(spec) == 1:
        return c1, None
    speccomb = c1 + spec[2] * cs['col' + spec[1]]
    return speccomb, c1 / speccomb


def _last_true_index(cond, default):
    """Per-column index of the last True along axis 0, else default."""
    nz = cond.shape[0]
    rev = cond[::-1]
    idx = nz - 1 - jnp.argmax(rev, axis=0)
    return jnp.where(jnp.any(cond, axis=0), idx, default)


def taumol_sw(cs, isolvar, svar_f, svar_s, svar_i,
              svar_f_bnd, svar_s_bnd, svar_i_bnd, dtype):
    """Gaseous + Rayleigh optical depth and solar source per g-point.

    Returns taug, taur: (nz, ncol, 112); sflux: (ncol, 112) — the solar
    source at the band's reference layer (sfluxzen for isolvar<0, the
    NRLSSI2 ssi for isolvar>=0), mirroring rrtmg_sw_taumol.f90.
    """
    t = load_tables()
    trop = cs['trop']
    nz, ncol = trop.shape
    jp, jt0, jt10 = cs['jp'], cs['jt0'], cs['jt10']
    ltrop_idx = jnp.maximum(jnp.sum(trop, axis=0) - 1, 0)  # last trop layer

    taug_parts, taur_parts, sflux_parts = [], [], []
    for bi, bd in enumerate(BANDS):
        num, ng = bd['num'], NG[bi]
        nspa, nspb = NSPA[bi], NSPB[bi]

        def tab(name, b=num):
            key = 'b%d_%s' % (b, name)
            return jnp.asarray(t[key], dtype) if key in t else None

        speccomb_l, specparm_l = _key_spec(bd['lo'], cs)
        speccomb_u, specparm_u = _key_spec(bd['up'], cs)
        if speccomb_u is not None and bd.get('up_col_scale'):
            speccomb_u = speccomb_u * bd['up_col_scale']

        js0_l = fs_l = js0_u = fs_u = None
        if specparm_l is not None:
            js0_l, fs_l = _eta(specparm_l, 8, dtype)
        if specparm_u is not None:
            js0_u, fs_u = _eta(specparm_u, 4, dtype)

        taug = jnp.zeros((nz, ncol, ng), dtype)

        # --- key-species interpolated absorption -----------------------
        absa, absb = tab('absa'), tab('absb')
        have_lo = bd['lo'] is not None
        have_up = bd['up'] is not None
        if have_lo or have_up:
            zero_i = jnp.zeros_like(jp)
            zero_f = jnp.zeros(trop.shape, dtype)
            # lower-atmosphere index/weights
            if have_lo:
                jsl = js0_l if js0_l is not None else zero_i
                fsl = fs_l if fs_l is not None else zero_f
                ind0a = (cs['jp0'] * 5 + jt0) * nspa + jsl
                ind1a = ((cs['jp0'] + 1) * 5 + jt10) * nspa + jsl
            if have_up:
                jsu = js0_u if js0_u is not None else zero_i
                fsu = fs_u if fs_u is not None else zero_f
                ind0b = ((jp - 13) * 5 + jt0) * nspb + jsu
                ind1b = ((jp - 12) * 5 + jt10) * nspb + jsu

            if have_lo and have_up:
                table = jnp.concatenate([absa, absb], axis=0)
                rows_a = absa.shape[0]
            elif have_lo:
                table, rows_a = absa, absa.shape[0]
            else:
                table, rows_a = absb, 0

            if have_lo and have_up:
                speccomb = jnp.where(trop, speccomb_l, speccomb_u)
            elif have_lo:
                speccomb = jnp.where(trop, speccomb_l, 0.0)
            else:
                speccomb = jnp.where(trop, 0.0, speccomb_u)
            kscale = bd.get('kscale_lo')
            if kscale:
                speccomb = speccomb * jnp.where(trop, kscale, 1.0)

            # 8-term 2x2x2 (pressure, temperature, eta) interpolation as
            # sparse-weight dot contractions; speccomb (and band 23's
            # kscale) fold into the term weights.  f32 splits regimes
            # and contracts per-level table windows
            # (interp.mix_rows_windowed); f64 keeps the merged
            # full-table path (golden parity).
            use_window = dtype != jnp.float64
            if have_lo:
                sc_lo = speccomb_l * (bd.get('kscale_lo') or 1.0)
            if have_up:
                sc_up = speccomb_u
            terms = []
            terms_lo, terms_up = [], []
            for ind_sel, f0, f1 in (
                    ('i0', 'fac00', 'fac10'), ('i1', 'fac01', 'fac11')):
                for fac_name, nsp_off in ((f0, 0), (f1, 1)):
                    for eta_off in (0, 1):
                        if eta_off and nspa != 9 and nspb != 5:
                            continue    # eta term absent on both sides
                        fac = cs[fac_name]
                        if have_lo:
                            wl = fac * (fsl if eta_off else (1.0 - fsl))
                            il = ((ind0a if ind_sel == 'i0' else ind1a)
                                  + nsp_off * nspa + eta_off)
                        if have_up:
                            wu = fac * (fsu if eta_off else (1.0 - fsu))
                            iu = ((ind0b if ind_sel == 'i0' else ind1b)
                                  + nsp_off * nspb + eta_off)
                        if use_window:
                            if have_lo and not (eta_off and nspa != 9):
                                terms_lo.append(
                                    (il, jnp.where(trop, wl * sc_lo, 0.0)))
                            if have_up and not (eta_off and nspb != 5):
                                terms_up.append(
                                    (iu, jnp.where(trop, 0.0, wu * sc_up)))
                            continue
                        if have_lo and have_up:
                            w = jnp.where(trop, wl, wu)
                            idx = jnp.where(trop, il, rows_a + iu)
                        elif have_lo:
                            w = jnp.where(trop, wl, 0.0)
                            idx = il
                        else:
                            w = jnp.where(trop, 0.0, wu)
                            idx = iu
                        terms.append((idx, w * speccomb))
            if use_window:
                if have_lo:
                    taug = taug + mix_rows_windowed(
                        absa, terms_lo, 4 * 5 * nspa)
                if have_up:
                    taug = taug + mix_rows_windowed(
                        absb, terms_up, 4 * 5 * nspb)
            else:
                taug = taug + mix_rows(table, terms)

        # --- water-vapor self/foreign continuum -------------------------
        selfref, forref = tab('selfref'), tab('forref')
        if bd['self_lo'] or bd['for_lo'] or bd['for_up']:
            colh2o = cs['colh2o']
            if bd['self_lo']:
                taug = taug + lin_rows(
                    selfref, cs['indself'], cs['selffrac'],
                    jnp.where(trop, cs['selffac'], 0.0) * colh2o)
            if bd['for_lo'] and bd['for_up']:
                fmask = jnp.ones_like(trop)
            elif bd['for_lo']:
                fmask = trop
            elif bd['for_up']:
                fmask = ~trop
            if bd['for_lo'] or bd['for_up']:
                taug = taug + lin_rows(
                    forref, cs['indfor'], cs['forfrac'],
                    jnp.where(fmask, cs['forfac'], 0.0) * colh2o)

        # --- minor absorbers --------------------------------------------
        for gas, table_name, regime in bd.get('extra', ()):
            coef = tab(table_name)
            col = cs['col' + gas]
            if regime == 'both':
                mask = jnp.ones_like(trop)
            elif regime == 'lo':
                mask = trop
            else:
                mask = ~trop
            taug = taug + jnp.where(mask, col, 0.0)[..., None] * coef

        if bd.get('o2cont'):
            o2cont = 4.35e-4 * cs['colo2'] / (350.0 * 2.0)
            taug = taug + o2cont[..., None]

        # --- Rayleigh ----------------------------------------------------
        colmol = cs['colmol']
        rayl = tab('rayl')
        if bd['rayl'] == 'c':
            taur = colmol[..., None] * rayl
        elif bd['rayl'] == 'pg':
            taur = colmol[..., None] * rayl[None, None, :]
        else:  # band 24: eta-interpolated lower, raylb upper
            rayla, raylb = tab('rayla'), tab('raylb')
            # rayla stored (ng, 9): interpolate at (js, fs) of lower eta
            r_lo = lin_rows(rayla.T, js0_l, fs_l)       # (nz, ncol, ng)
            taur = colmol[..., None] * jnp.where(
                trop[..., None], r_lo, raylb[None, None, :])
        taur = jnp.broadcast_to(taur, (nz, ncol, ng)).astype(dtype)

        # --- solar source at the reference layer -------------------------
        where, neta = bd['sflux']
        layreffr = bd['layreffr']
        if where == 'lo':
            cond = trop & (jp < layreffr)
            cond = cond & (jnp.roll(jp, -1, axis=0) >= layreffr)
            cond = cond.at[-1].set(False)
            lay = jnp.minimum(_last_true_index(cond, ltrop_idx) + 1,
                              ltrop_idx)
        else:
            cond = (~trop) & (jp >= layreffr)
            condp = jnp.concatenate(
                [jnp.zeros((1, ncol), bool), jp[:-1] < layreffr], axis=0)
            cond = cond & condp
            lay = _last_true_index(cond, nz - 1)

        def at_ref(x, lay=lay):
            return jnp.take_along_axis(x, lay[None, :], axis=0)[0]

        def source(name):
            ref = tab(name)
            if neta == 0:
                return jnp.broadcast_to(ref[None, :], (ncol, ng))
            js_sol = at_ref(js0_l if where == 'lo' else js0_u)
            fs_sol = at_ref(fs_l if where == 'lo' else fs_u)
            return lin_rows(ref.T, js_sol, fs_sol)      # (ncol, ng)

        scale = bd.get('sflux_scale', 1.0)
        if isolvar < 0:
            sflux = source('sfluxref') * scale
        elif isolvar <= 2:
            sflux = (svar_f * source('facbrght')
                     + svar_s * source('snsptdrk')
                     + svar_i * source('irradnce'))
        else:
            sflux = (svar_f_bnd[bi] * source('facbrght')
                     + svar_s_bnd[bi] * source('snsptdrk')
                     + svar_i_bnd[bi] * source('irradnce'))

        taug_parts.append(taug)
        taur_parts.append(taur)
        sflux_parts.append(sflux)

    return (jnp.concatenate(taug_parts, axis=-1),
            jnp.concatenate(taur_parts, axis=-1),
            jnp.concatenate(sflux_parts, axis=-1))


def _exp_transmittance(tau, use_tables=True):
    """exp(-tau) via the Fortran Pade lookup (rrtmg_sw_init.f90:100-123).

    Matches reference arithmetic: below od_lo a quadratic expansion,
    above it the 10000-entry table on the Pade-transformed argument.

    use_tables=False computes ``exp(-tau)`` directly instead: the table
    only quantizes the exact exponential (it exists so the Fortran could
    avoid transcendentals) — the fast path is used by the fused GCM and
    the benchmark, the table path by the f64 golden-parity tests.  Per
    element, a gather into a 10^4-entry table against one exponential has
    not been timed on the GPU.
    """
    ze1 = jnp.minimum(tau, 500.0)
    if not use_tables:
        # clamp at the table's EXPEPS floor: f32 exp underflows to 0 for
        # tau > ~88 and the reftra solver takes 1/zem1 of this value
        return jnp.maximum(jnp.exp(-ze1), EXPEPS)
    small = 1.0 - ze1 + 0.5 * ze1 * ze1
    tblind = ze1 / (BPADE + ze1)
    itind = _trunc_int(NTBL * tblind + 0.5)
    lut = jnp.asarray(EXP_TBL, tau.dtype)[itind]
    return jnp.where(ze1 <= OD_LO, small, lut)


def reftra_sw(tau, omega, g, mu0, active, use_tables=True):
    """Two-stream reflectance/transmittance (rrtmg_sw_reftra.f90 kmodts=2).

    All args broadcastable to (nz, ncol, ngpt); mu0 is (ncol, 1) or
    scalar-like.  Returns (ref, refd, tra, trad).
    """
    dtype = tau.dtype
    eps = 1.0e-8
    zwcrit = 0.9999995
    zg3 = 3.0 * g
    gamma1 = (8.0 - omega * (5.0 + zg3)) * 0.25
    gamma2 = 3.0 * (omega * (1.0 - g)) * 0.25
    gamma3 = (2.0 - zg3 * mu0) * 0.25
    gamma4 = 1.0 - gamma3

    zwo = omega / (1.0 - (1.0 - omega) * (g / (1.0 - g)) ** 2)
    conservative = zwo >= zwcrit

    # --- conservative scattering branch
    za = gamma1 * mu0
    za1 = za - gamma3
    zgt = gamma1 * tau
    ze2c = _exp_transmittance(tau / mu0, use_tables)
    ref_c = jnp.where(ze2c == 1.0, 0.0,
                      (zgt - za1 * (1.0 - ze2c)) / (1.0 + zgt))
    tra_c = 1.0 - ref_c
    refd_c = jnp.where(ze2c == 1.0, 0.0, zgt / (1.0 + zgt))
    trad_c = 1.0 - refd_c

    # --- non-conservative branch
    za1n = gamma1 * gamma4 + gamma2 * gamma3
    za2n = gamma1 * gamma3 + gamma2 * gamma4
    zrk = jnp.sqrt(jnp.maximum(gamma1 * gamma1 - gamma2 * gamma2, eps * eps))
    zrp = zrk * mu0
    zrp1 = 1.0 + zrp
    zrm1 = 1.0 - zrp
    zrk2 = 2.0 * zrk
    zrpp = 1.0 - zrp * zrp
    zrkg = zrk + gamma1
    zr1 = zrm1 * (za2n + zrk * gamma3)
    zr2 = zrp1 * (za2n - zrk * gamma3)
    zr3 = zrk2 * (gamma3 - za2n * mu0)
    zr4 = zrpp * zrkg
    zr5 = zrpp * (zrk - gamma1)
    zt1 = zrp1 * (za1n + zrk * gamma4)
    zt2 = zrm1 * (za1n - zrk * gamma4)
    zt3 = zrk2 * (gamma4 + za1n * mu0)
    zbeta = (gamma1 - zrk) / zrkg

    zem1 = _exp_transmittance(jnp.minimum(zrk * tau, 500.0), use_tables)
    zep1 = 1.0 / zem1
    zem2 = _exp_transmittance(jnp.minimum(tau / mu0, 500.0), use_tables)
    zep2 = 1.0 / zem2

    zdenr = zr4 * zep1 + zr5 * zem1
    zdent = zt4 = zr4 * zep1 + zr5 * zem1
    denr_small = jnp.abs(zdenr) <= eps
    ref_n = jnp.where(
        denr_small, eps,
        omega * (zr1 * zep1 - zr2 * zem1 - zr3 * zem2)
        / jnp.where(denr_small, 1.0, zdenr))
    tra_n = jnp.where(
        denr_small, zem2,
        zem2 - zem2 * omega * (zt1 * zep1 - zt2 * zem1 - zt3 * zep2)
        / jnp.where(denr_small, 1.0, zdent))
    zemm = zem1 * zem1
    zdend = 1.0 / ((1.0 - zbeta * zemm) * zrkg)
    refd_n = gamma2 * (1.0 - zemm) * zdend
    trad_n = zrk2 * zem1 * zdend

    ref = jnp.where(conservative, ref_c, ref_n)
    refd = jnp.where(conservative, refd_c, refd_n)
    tra = jnp.where(conservative, tra_c, tra_n)
    trad = jnp.where(conservative, trad_c, trad_n)

    ref = jnp.where(active, ref, 0.0).astype(dtype)
    refd = jnp.where(active, refd, 0.0).astype(dtype)
    tra = jnp.where(active, tra, 1.0).astype(dtype)
    trad = jnp.where(active, trad, 1.0).astype(dtype)
    return ref, refd, tra, trad


def vrtqdr_sw(ref, refd, tra, trad, dbt, tdbt, alb_dir, alb_dif):
    """Adding method (rrtmg_sw_vrtqdr.f90), scan over levels.

    Layer arrays (nz, ...) are TOP-DOWN (index 0 = top layer); level
    arrays are (nz+1, ...) with 0 = TOA.  alb_* broadcast to layer shape.
    Returns (fd, fu) normalized flux profiles (nz+1, ...).
    """
    nz = ref.shape[0]
    # extend with the surface "layer" = albedo row
    surf_ref = jnp.broadcast_to(alb_dir, ref.shape[1:])
    surf_refd = jnp.broadcast_to(alb_dif, ref.shape[1:])

    # upward pass: prup/prupd from surface to TOA
    def up_step(carry, xs):
        prup_b, prupd_b = carry
        r, rd, tr, trd, db = xs
        zreflect = 1.0 / (1.0 - prupd_b * rd)
        prup = r + (trd * ((tr - db) * prupd_b + db * prup_b)) * zreflect
        prupd = rd + trd * trd * prupd_b * zreflect
        return (prup, prupd), (prup, prupd)

    xs = (ref[::-1], refd[::-1], tra[::-1], trad[::-1], dbt[::-1])
    (_, _), (prup_rev, prupd_rev) = lax.scan(
        up_step, (surf_ref, surf_refd), xs)
    prup = jnp.concatenate([prup_rev[::-1], surf_ref[None]], axis=0)
    prupd = jnp.concatenate([prupd_rev[::-1], surf_refd[None]], axis=0)

    # downward pass: ztdn/prdnd from TOA to surface
    one = jnp.ones_like(surf_ref)
    zero = jnp.zeros_like(surf_ref)

    def dn_step(carry, xs):
        ztdn_a, prdnd_a = carry
        r, rd, tr, trd, db, tdb = xs
        zreflect = 1.0 / (1.0 - rd * prdnd_a)
        ztdn = tdb * tr + (trd * ((ztdn_a - tdb)
                                  + tdb * r * prdnd_a)) * zreflect
        prdnd = rd + trd * trd * prdnd_a * zreflect
        return (ztdn, prdnd), (ztdn_a, prdnd_a)

    xs2 = (ref, refd, tra, trad, dbt, tdbt[:-1])
    (ztdn_s, prdnd_s), (ztdn_hist, prdnd_hist) = lax.scan(
        dn_step, (one, zero), xs2)
    ztdn = jnp.concatenate([ztdn_hist, ztdn_s[None]], axis=0)
    prdnd = jnp.concatenate([prdnd_hist, prdnd_s[None]], axis=0)

    zreflect = 1.0 / (1.0 - prdnd * prupd)
    fu = (tdbt * prup + (ztdn - tdbt) * prupd) * zreflect
    fd = tdbt + (ztdn - tdbt + tdbt * prup * prdnd) * zreflect
    return fd, fu


def cldprop_sw(inflag, iceflag, liqflag, cldfrac, tauc, ssac, asmc, fsfc,
               ciwp, clwp, rei, rel, dtype):
    """Cloud optical properties per band (rrtmg_sw_cldprop.f90).

    Array args are (nz, ncol[, nband]); returns taucloud/ssacloud/
    asmcloud/taucldorig of shape (nz, ncol, nband).
    """
    t = load_tables()
    cldmin = 1.0e-20
    nz, ncol = cldfrac.shape
    shape = (nz, ncol, NBANDS)

    cloudy = (cldfrac >= cldmin)[..., None]

    if inflag == 0:
        ffp = fsfc
        ffp1 = 1.0 - ffp
        ffpssa = 1.0 - ffp * ssac
        ssacloud = ffp1 * ssac / ffpssa
        taucloud = ffpssa * tauc
        asmcloud = (asmc - ffp) / ffp1
        sel = cloudy & (jnp.sum(tauc, -1, keepdims=True) >= cldmin)
        return (jnp.where(sel, taucloud, 0.0).astype(dtype),
                jnp.where(sel, ssacloud, 1.0).astype(dtype),
                jnp.where(sel, asmcloud, 0.0).astype(dtype),
                jnp.where(sel, tauc, 0.0).astype(dtype))

    assert inflag == 2, 'shortwave cldprop supports inflag 0 or 2'
    # --- ice optics
    radice = rei
    if iceflag == 1:
        icx = np.searchsorted(-np.array([1.43e4, 7.7e3, 5.3e3, 4.0e3]),
                              -WAVENUM2)  # 0..4 per band
        abari = t['cld_abari'][icx]
        bbari = t['cld_bbari'][icx]
        cbari = t['cld_cbari'][icx]
        dbari = t['cld_dbari'][icx]
        ebari = t['cld_ebari'][icx]
        fbari = t['cld_fbari'][icx]
        extcoice = abari + bbari / radice[..., None]
        ssacoice = 1.0 - cbari - dbari * radice[..., None]
        gice = jnp.minimum(ebari + fbari * radice[..., None], 1.0 - 1e-6)
        forwice = gice * gice
    elif iceflag == 2:
        factor = (radice - 2.0) / 3.0
        index = jnp.minimum(_trunc_int(factor), 42)
        fint = (factor - index)[..., None]
        ext2 = jnp.asarray(t['cld_extice2'], dtype)
        ssa2 = jnp.asarray(t['cld_ssaice2'], dtype)
        asy2 = jnp.asarray(t['cld_asyice2'], dtype)
        i0 = index - 1                       # table rows are 1-based
        i0 = jnp.clip(i0, 0, ext2.shape[0] - 2)
        extcoice = ext2[i0] + fint * (ext2[i0 + 1] - ext2[i0])
        ssacoice = ssa2[i0] + fint * (ssa2[i0 + 1] - ssa2[i0])
        gice = asy2[i0] + fint * (asy2[i0 + 1] - asy2[i0])
        forwice = gice * gice
    else:  # iceflag == 3 (Fu generalized effective size)
        factor = (radice - 2.0) / 3.0
        index = jnp.minimum(_trunc_int(factor), 45)
        fint = (factor - index)[..., None]
        ext3 = jnp.asarray(t['cld_extice3'], dtype)
        ssa3 = jnp.asarray(t['cld_ssaice3'], dtype)
        asy3 = jnp.asarray(t['cld_asyice3'], dtype)
        fdl3 = jnp.asarray(t['cld_fdlice3'], dtype)
        i0 = jnp.clip(index - 1, 0, ext3.shape[0] - 2)
        extcoice = ext3[i0] + fint * (ext3[i0 + 1] - ext3[i0])
        ssacoice = ssa3[i0] + fint * (ssa3[i0 + 1] - ssa3[i0])
        gice = asy3[i0] + fint * (asy3[i0 + 1] - asy3[i0])
        fdelta = fdl3[i0] + fint * (fdl3[i0 + 1] - fdl3[i0])
        forwice = jnp.minimum(fdelta + 0.5 / ssacoice, gice)

    no_ice = (ciwp == 0.0)[..., None]
    extcoice = jnp.where(no_ice, 0.0, extcoice)
    ssacoice = jnp.where(no_ice, 0.0, ssacoice)
    gice = jnp.where(no_ice, 0.0, gice)
    forwice = jnp.where(no_ice, 0.0, forwice)

    # --- liquid optics (liqflag 1: Hu & Stamnes radius-dependent)
    radliq = rel
    index = jnp.clip(_trunc_int(radliq - 1.5), 1, 57)
    fint = (radliq - 1.5 - index)[..., None]
    extl = jnp.asarray(t['cld_extliq1'], dtype)
    ssal = jnp.asarray(t['cld_ssaliq1'], dtype)
    asyl = jnp.asarray(t['cld_asyliq1'], dtype)
    i0 = index - 1
    extcoliq = extl[i0] + fint * (extl[i0 + 1] - extl[i0])
    ssacoliq = ssal[i0] + fint * (ssal[i0 + 1] - ssal[i0])
    ssacoliq = jnp.where((fint < 0.0) & (ssacoliq > 1.0), ssal[i0],
                         ssacoliq)
    gliq = asyl[i0] + fint * (asyl[i0 + 1] - asyl[i0])
    forwliq = gliq * gliq
    no_liq = (clwp == 0.0)[..., None]
    extcoliq = jnp.where(no_liq, 0.0, extcoliq)
    ssacoliq = jnp.where(no_liq, 0.0, ssacoliq)
    gliq = jnp.where(no_liq, 0.0, gliq)
    forwliq = jnp.where(no_liq, 0.0, forwliq)

    tauliqorig = clwp[..., None] * extcoliq
    tauiceorig = ciwp[..., None] * extcoice
    taucldorig = tauliqorig + tauiceorig
    den_l = 1.0 - forwliq * ssacoliq
    ssaliq = ssacoliq * (1.0 - forwliq) / den_l
    tauliq = den_l * tauliqorig
    den_i = jnp.where(forwice * ssacoice == 1.0, 1.0,
                      1.0 - forwice * ssacoice)
    ssaice = jnp.where(no_ice, 0.0, ssacoice * (1.0 - forwice) / den_i)
    tauice = den_i * tauiceorig
    scatliq = ssaliq * tauliq
    scatice = ssaice * tauice
    taucloud = tauliq + tauice
    taucloud = jnp.where(taucloud == 0.0, cldmin, taucloud)
    scatice = jnp.where(scatice == 0.0, cldmin, scatice)
    ssacloud = (scatliq + scatice) / taucloud
    g_l = (gliq - forwliq) / jnp.where(forwliq == 1.0, 1.0, 1.0 - forwliq)
    g_i = (gice - forwice) / jnp.where(forwice == 1.0, 1.0, 1.0 - forwice)
    if iceflag == 3:
        asmcloud = (scatliq * g_l + scatice * g_i) / (scatliq + scatice)
    else:
        asmcloud = (scatliq * g_l + scatice * g_i) / (scatliq + scatice)

    sel = cloudy & ((ciwp + clwp >= cldmin)[..., None])
    return (jnp.where(sel, taucloud, 0.0).astype(dtype),
            jnp.where(sel, ssacloud, 1.0).astype(dtype),
            jnp.where(sel, asmcloud, 0.0).astype(dtype),
            jnp.where(sel, taucldorig, 0.0).astype(dtype))


def spcvrt_sw(taug, taur, sflux, adjflux_band, mu0, alb_dir_band,
              alb_dif_band, cldfrac, tauc_b, ssac_b, asmc_b,
              taua_b, ssaa_b, asma_b, icld, use_tables=True):
    """Two-stream solver over all g-points (rrtmg_sw_spcvrt.f90).

    taug/taur: (nz, ncol, ngpt) bottom-up.  sflux: (ncol, ngpt).
    adjflux_band: (nband,) or (ncol, nband).  *_band: (ncol, nband).
    *_b cloud/aerosol optics: (nz, ncol, nband).
    Returns (fd, fu, fd_clear, fu_clear): (nz+1, ncol) bottom-up levels.
    """
    dtype = taug.dtype
    nz, ncol, _ = taug.shape
    ngb = jnp.asarray(NGB)

    # flip to internal top-down layer order
    taug = taug[::-1]
    taur = taur[::-1]
    cf = cldfrac[::-1][..., None]                     # (nz, ncol, 1)
    taua = taua_b[::-1][:, :, NGB]
    omga = ssaa_b[::-1][:, :, NGB]
    asya = asma_b[::-1][:, :, NGB]
    tauc = tauc_b[::-1][:, :, NGB]
    omgc = ssac_b[::-1][:, :, NGB]
    asyc = asmc_b[::-1][:, :, NGB]

    mu0b = mu0[None, :, None]                         # (1, ncol, 1)
    incflx = (jnp.asarray(adjflux_band, dtype)[NGB] * sflux
              * mu0[:, None])                         # (ncol, ngpt)

    # clear-sky optics + delta scaling (spcvrt_sw.f90)
    ztauc = taur + taug + taua
    zomcc = taur * 1.0 + taua * omga
    zgcc = asya * omga * taua / jnp.maximum(zomcc, 1e-300)
    zomcc = zomcc / ztauc
    zf = zgcc * zgcc
    zwf = zomcc * zf
    ztauc_d = (1.0 - zwf) * ztauc
    zomcc_d = (zomcc - zwf) / (1.0 - zwf)
    zgcc_d = (zgcc - zf) / (1.0 - zf)

    # total-sky optics (icpr=0 path: combine unscaled then delta scale)
    ztauo = taur + taug + taua + tauc
    zomco = taua * omga + tauc * omgc + taur * 1.0
    zgco = (tauc * omgc * asyc + taua * omga * asya) / jnp.maximum(
        zomco, 1e-300)
    zomco = zomco / ztauo
    zfo = zgco * zgco
    zwfo = zomco * zfo
    ztauo_d = (1.0 - zwfo) * ztauo
    zomco_d = (zomco - zwfo) / (1.0 - zwfo)
    zgco_d = (zgco - zfo) / (1.0 - zfo)

    return _spcv_core(ztauc_d, zomcc_d, zgcc_d, ztauo_d, zomco_d, zgco_d,
                      cf, mu0b, alb_dir_band, alb_dif_band, incflx, icld,
                      use_tables)


def _spcv_core(ztauc_d, zomcc_d, zgcc_d, ztauo_d, zomco_d, zgco_d, cf,
               mu0b, alb_dir_band, alb_dif_band, incflx, icld,
               use_tables=True):
    """Shared two-stream tail of spcvrt/spcvmc: reflectivities, direct
    beam, clear/cloudy combination, and the vrtqdr adding sweep.

    All optics are top-down (nz, ncol, ngpt), delta-scaled; cf is the
    cloud fraction per (layer, column, 1) [spcvrt] or the binary McICA
    subcolumn mask per (layer, column, ngpt) [spcvmc].

    icld is STATIC: when 0, the total sky IS the clear sky and the
    cloudy reflectivity pass plus the second adding sweep are skipped
    entirely (XLA then dead-code-eliminates the unused cloud optics).
    """
    dtype = ztauc_d.dtype
    ncol = ztauc_d.shape[1]
    clear_only = isinstance(icld, int) and icld == 0

    refc, refdc, trac, tradc = reftra_sw(
        ztauc_d, zomcc_d, zgcc_d, mu0b, jnp.ones_like(ztauc_d, bool),
        use_tables)
    zdbtc = _exp_transmittance(ztauc_d / mu0b, use_tables)

    ones_lvl = jnp.ones((1, ncol, NGPT), dtype)
    ztdbtc = jnp.concatenate([ones_lvl, jnp.cumprod(zdbtc, axis=0)], axis=0)

    albp = alb_dir_band[:, NGB]                       # (ncol, ngpt)
    albd = alb_dif_band[:, NGB]

    fd_c, fu_c = vrtqdr_sw(refc, refdc, trac, tradc, zdbtc, ztdbtc,
                           albp, albd)

    def total(f):
        return jnp.einsum('lcg,cg->lc', f, incflx,
                          precision=dot_precision('physics'))[::-1]

    if clear_only:
        fd = total(fd_c)
        fu = total(fu_c)
        return fd, fu, fd, fu

    active_cld = cf > 1e-12
    refo, refdo, trao, trado = reftra_sw(
        ztauo_d, zomco_d, zgco_d, mu0b, active_cld, use_tables)
    zdbto = _exp_transmittance(ztauo_d / mu0b, use_tables)

    zref = (1.0 - cf) * refc + cf * refo
    zrefd = (1.0 - cf) * refdc + cf * refdo
    ztra = (1.0 - cf) * trac + cf * trao
    ztrad = (1.0 - cf) * tradc + cf * trado
    zdbt = (1.0 - cf) * zdbtc + cf * zdbto

    ztdbt = jnp.concatenate([ones_lvl, jnp.cumprod(zdbt, axis=0)], axis=0)

    fd_t, fu_t = vrtqdr_sw(zref, zrefd, ztra, ztrad, zdbt, ztdbt,
                           albp, albd)

    return total(fd_t), total(fu_t), total(fd_c), total(fu_c)


def spcvmc_sw(taug, taur, sflux, adjflux_band, mu0, alb_dir_band,
              alb_dif_band, cldfmc_g, taucmc_g, ssacmc_g, asmcmc_g,
              taua_b, ssaa_b, asma_b, use_tables=True):
    """McICA two-stream solver (rrtmg_sw_spcvmc.f90, icpr=1 path).

    Cloud optics are per-g-point stochastic subcolumns, already
    delta-scaled (the cldprmc convention, rrtmg_sw_cldprmc.f90): the
    total-sky optics combine the delta-scaled clear column with the
    delta-scaled per-subcolumn cloud directly
    (rrtmg_sw_spcvmc.f90:500-505), and the clear/cloudy weighting uses
    the binary subcolumn mask cldfmc (spcvmc.f90:543-551).

    taug/taur/cldfmc_g/taucmc_g/ssacmc_g/asmcmc_g: (nz, ncol, ngpt)
    bottom-up; aerosol *_b per band (nz, ncol, nband).
    """
    dtype = taug.dtype

    taug = taug[::-1]
    taur = taur[::-1]
    cf = cldfmc_g[::-1]
    tauc = taucmc_g[::-1]
    omgc = ssacmc_g[::-1]
    asyc = asmcmc_g[::-1]
    taua = taua_b[::-1][:, :, NGB]
    omga = ssaa_b[::-1][:, :, NGB]
    asya = asma_b[::-1][:, :, NGB]

    mu0b = mu0[None, :, None]
    incflx = (jnp.asarray(adjflux_band, dtype)[NGB] * sflux
              * mu0[:, None])

    # clear-sky optics + delta scaling (spcvmc_sw.f90:441-487)
    ztauc = taur + taug + taua
    zomcc = taur * 1.0 + taua * omga
    zgcc = asya * omga * taua / jnp.maximum(zomcc, 1e-300)
    zomcc = zomcc / ztauc
    zf = zgcc * zgcc
    zwf = zomcc * zf
    ztauc_d = (1.0 - zwf) * ztauc
    zomcc_d = (zomcc - zwf) / (1.0 - zwf)
    zgcc_d = (zgcc - zf) / (1.0 - zf)

    # total-sky: delta-scaled clear + delta-scaled subcolumn cloud
    # (icpr=1, spcvmc_sw.f90:500-505)
    ztauo_d = ztauc_d + tauc
    zomco_raw = ztauc_d * zomcc_d + tauc * omgc
    zgco_d = (tauc * omgc * asyc + ztauc_d * zomcc_d * zgcc_d) \
        / jnp.maximum(zomco_raw, 1e-300)
    zomco_d = zomco_raw / ztauo_d

    return _spcv_core(ztauc_d, zomcc_d, zgcc_d, ztauo_d, zomco_d, zgco_d,
                      cf, mu0b, alb_dir_band, alb_dif_band, incflx,
                      icld=1, use_tables=use_tables)


def earth_sun(day_of_year):
    """Earth-sun distance flux factor (rrtmg_sw_rad.nomcica.f90:834-841)."""
    gamma = 2.0 * np.pi * (day_of_year - 1) / 365.0
    return (1.000110 + 0.034221 * np.cos(gamma) + 0.001289 * np.sin(gamma)
            + 0.000719 * np.cos(2.0 * gamma)
            + 0.000077 * np.sin(2.0 * gamma))


def solar_variability(isolvar, scon, solcycfrac=0.0, indsolvar=(1.0, 1.0),
                      bndsolvar=None):
    """svar_f/s/i factors and per-band adjustments (rad.f90:1196-1420).

    Returns (svar_f, svar_s, svar_i, svar_f_bnd, svar_s_bnd, svar_i_bnd,
    solvar_band): plain floats/np arrays (static configuration values).
    """
    t = load_tables()
    svar_f = svar_s = svar_i = 1.0
    svar_bnd = [np.ones(NBANDS)] * 3
    solvar = np.ones(NBANDS)
    ind1, ind2 = float(indsolvar[0]), float(indsolvar[1])
    sf = float(solcycfrac)

    if (ind1 != 1.0 or ind2 != 1.0) and isolvar == 1:
        if 0.0 <= sf < 0.0229:
            wgt = (sf + 1.0 - 0.3817) / (1.0229 - 0.3817)
            ind1, ind2 = (v + wgt * (1.0 - v) for v in (ind1, ind2))
        elif 0.0229 <= sf <= 0.3817:
            wgt = (sf - 0.0229) / (0.3817 - 0.0229)
            ind1, ind2 = (1.0 + wgt * (v - 1.0) for v in (ind1, ind2))
        elif sf <= 1.0:
            wgt = (sf - 0.3817) / (1.0229 - 0.3817)
            ind1, ind2 = (v + wgt * (1.0 - v) for v in (ind1, ind2))

    def cyc_interp():
        mg, sb = t['mgavgcyc'], t['sbavgcyc']
        n = len(mg)
        if sf <= 0.0:
            return mg[0], sb[0]
        if sf >= 1.0:
            return mg[-1], sb[-1]
        sfid = int(np.floor(sf * (n - 1))) + 1
        fraclo = (sfid - 1) / (n - 1)
        frachi = sfid / (n - 1)
        intfrac = (sf - fraclo) / (frachi - fraclo)
        a = mg[sfid - 1] + intfrac * (mg[sfid] - mg[sfid - 1])
        b = sb[sfid - 1] + intfrac * (sb[sfid] - sb[sfid - 1])
        return a, b

    if scon == 0.0:
        if isolvar == 0:
            svar_f = svar_s = svar_i = 1.0
        elif isolvar == 1:
            a, b = cyc_interp()
            svar_f = ind1 * (a - FOFFSET) / (SVAR_F_AVG - FOFFSET)
            svar_s = ind2 * (b - SOFFSET) / (SVAR_S_AVG - SOFFSET)
            svar_i = 1.0
        elif isolvar == 2:
            svar_f = (ind1 - FOFFSET) / (SVAR_F_AVG - FOFFSET)
            svar_s = (ind2 - SOFFSET) / (SVAR_S_AVG - SOFFSET)
            svar_i = 1.0
        elif isolvar == 3:
            sb = np.ones(NBANDS) if bndsolvar is None else np.asarray(
                bndsolvar)[:NBANDS]
            svar_bnd = [sb, sb, sb]
        if isolvar == -1 and bndsolvar is not None:
            solvar = np.asarray(bndsolvar)[:NBANDS]
    else:
        if isolvar == -1:
            solvar = np.full(NBANDS, scon / RRSW_SCON)
            if bndsolvar is not None:
                solvar = np.asarray(bndsolvar)[:NBANDS] * scon / RRSW_SCON
        elif isolvar == 0:
            svar_f = svar_s = svar_i = scon / SVAR_CPRIM
        elif isolvar == 1:
            a, b = cyc_interp()
            svar_i = (scon - (ind1 * FINT + ind2 * SINT)) / IINT
            svar_f = ind1 * (a - FOFFSET) / (SVAR_F_AVG - FOFFSET)
            svar_s = ind2 * (b - SOFFSET) / (SVAR_S_AVG - SOFFSET)
        elif isolvar == 3:
            sb = np.ones(NBANDS) if bndsolvar is None else np.asarray(
                bndsolvar)[:NBANDS]
            sb = sb * scon / SVAR_CPRIM
            svar_bnd = [sb, sb, sb]
    return (svar_f, svar_s, svar_i, svar_bnd[0], svar_bnd[1], svar_bnd[2],
            solvar)


def rrtmg_sw_fluxes(play, plev, tlay, h2ovmr, o3vmr, co2vmr, ch4vmr,
                    n2ovmr, o2vmr, asdir, asdif, aldir, aldif, coszen,
                    cldfrac, cloud_optics, aerosol_optics,
                    adjes, day_of_year, scon, isolvar,
                    solar_config, grav, avogadro, cpdair, icld,
                    per_g_cloud=False, cloud_g=None, use_tables=True):
    """Full shortwave driver (rrtmg_sw_rad.nomcica.f90 rrtmg_sw).

    Pressures in mb (play (nz, ncol), plev (nz+1, ncol), bottom-up); gas
    amounts are volume mixing ratios; coszen (ncol,).
    cloud_optics: (tauc, ssac, asmc, taucorig) per band (nz, ncol, nband).
    aerosol_optics: (taua, ssaa, asma) per band.
    solar_config: output tuple of solar_variability().
    When per_g_cloud=True, cloud_g = (cldfmc, taucmc, ssacmc, asmcmc)
    McICA subcolumn optics of shape (nz, ncol, 112) replace the band
    cloud optics and the solver runs the spcvmc path (rrtmg_sw_rad.f90).
    Returns (swuflx, swdflx, swuflxc, swdflxc) on (nz+1, ncol) bottom-up
    levels plus (swhr, swhrc) heating rates in K/day (nz, ncol).
    """
    dtype = play.dtype
    (svar_f, svar_s, svar_i, svf_b, svs_b, svi_b, solvar) = solar_config

    adjflx = earth_sun(day_of_year) if day_of_year > 0 else adjes
    if isolvar < 0:
        adjflux_band = adjflx * np.asarray(solvar)
    else:
        adjflux_band = adjflx * jnp.ones(NBANDS, dtype)

    cossza = jnp.maximum(coszen, 1.0e-10)

    # inatm: molecular amounts and dry-air column (rad.f90:1425-1483)
    pdp = plev[:-1] - plev[1:]
    amm = (1.0 - h2ovmr) * AMD + h2ovmr * AMW
    coldry = pdp * 1.0e3 * avogadro / (
        1.0e2 * grav * amm * (1.0 + h2ovmr))
    wkl = {g: vmr * coldry for g, vmr in (
        ('h2o', h2ovmr), ('co2', co2vmr), ('o3', o3vmr),
        ('n2o', n2ovmr), ('ch4', ch4vmr), ('o2', o2vmr))}

    cs = setcoef_sw(play, tlay, coldry, wkl)
    taug, taur, sflux = taumol_sw(
        cs, isolvar, svar_f, svar_s, svar_i, svf_b, svs_b, svi_b, dtype)

    # band albedos: NIR bands 16-24 & 29 (idx 0-8, 13); UV/vis 25-28
    # (idx 9-12)  (rad.f90:648-659)
    alb_dir = jnp.stack(
        [aldir] * 9 + [asdir] * 4 + [aldir], axis=-1)   # (ncol, nband)
    alb_dif = jnp.stack([aldif] * 9 + [asdif] * 4 + [aldif], axis=-1)

    tauc_b, ssac_b, asmc_b, _ = cloud_optics
    taua_b, ssaa_b, asma_b = aerosol_optics

    if per_g_cloud:
        cldfmc_g, taucmc_g, ssacmc_g, asmcmc_g = cloud_g
        fd, fu, fdc, fuc = spcvmc_sw(
            taug, taur, sflux, adjflux_band, cossza, alb_dir, alb_dif,
            cldfmc_g, taucmc_g, ssacmc_g, asmcmc_g,
            taua_b, ssaa_b, asma_b, use_tables=use_tables)
    else:
        fd, fu, fdc, fuc = spcvrt_sw(
            taug, taur, sflux, adjflux_band, cossza, alb_dir, alb_dif,
            cldfrac, tauc_b, ssac_b, asmc_b, taua_b, ssaa_b, asma_b,
            icld, use_tables=use_tables)

    heatfac = grav * 86400.0 * 1.0e-5 / (cpdair * 1.0e-3)
    net = fd - fu
    netc = fdc - fuc
    swhr = heatfac * (net[1:] - net[:-1]) / pdp
    swhrc = heatfac * (netc[1:] - netc[:-1]) / pdp
    return fu, fd, fuc, fdc, swhr, swhrc


def ecmwf_aerosol_optics(ecaer, dtype):
    """ECMWF six-type aerosol -> band optics (rad.f90:682-717).

    ecaer: (naer=6, nz, ncol) optical depth at 0.55 micron.
    Returns (taua, ssaa, asma): (nz, ncol, nband).
    """
    t = load_tables()
    rsrtaua = jnp.asarray(t['aer_rsrtaua'], dtype)   # (nband, naer)
    rsrpiza = jnp.asarray(t['aer_rsrpiza'], dtype)
    rsrasya = jnp.asarray(t['aer_rsrasya'], dtype)
    ec = jnp.moveaxis(ecaer, 0, -1)                  # (nz, ncol, naer)
    prec = dot_precision('physics')
    taua = jnp.einsum('zca,ba->zcb', ec, rsrtaua, precision=prec)
    zomga = jnp.einsum('zca,ba->zcb', ec, rsrtaua * rsrpiza, precision=prec)
    zasya = jnp.einsum('zca,ba->zcb', ec, rsrtaua * rsrpiza * rsrasya,
                       precision=prec)
    asma = jnp.where(zomga != 0.0, zasya / jnp.where(zomga == 0, 1, zomga),
                     zasya)
    ssaa = jnp.where(taua != 0.0, zomga / jnp.where(taua == 0, 1, taua),
                     1.0)
    return taua, ssaa, asma
