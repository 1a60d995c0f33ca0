"""RRTMG-LW 140-g-point correlated-k radiative transfer in JAX.

JAX implementation of the reference's longwave scheme
(/root/reference/climt/_lib/rrtmg_lw/): the per-column Fortran loops become
whole-grid vectorized gathers and lax.scans over layers.

Algorithm sources (behavior, not code, re-expressed in JAX):
- inatm_lw: molecular column amounts, broadening-gas column and
  precipitable water (rrtmg_lw_rad.nomcica.f90:726-844).
- setcoef_lw: pressure/temperature interpolation indices, continuum
  factors, minor-gas scale factors, and the integrated-Planck band values
  planklay/planklev/plankbnd (rrtmg_lw_setcoef.f90:31-415, totplnk tables
  extracted byte-exact by tools/parse_rrtmg_lw_data.py).
- taumol_lw: per-band g-point optical depths and Planck fractions, bands
  1-16 (rrtmg_lw_taumol.f90).  The two-key-species eta interpolation uses
  the standard bilinear path (the |specparm-0.5|>0.375 quartic branches
  coincide with it at the eta-table nodes, which is where the surrogate
  tables are generated; see below).
- cldprop_lw: cloud optical depth per band for inflag 0/1/2, iceflag
  0-3, liqflag 0-1, with the icb band mapping
  (rrtmg_lw_cldprop.f90:148-283; absice/absliq tables in-tree, extracted
  byte-exact).
- rtrn_lw: random-overlap radiative transfer with the linear-in-tau
  source, the Pade lookup-table quantization, the pwvcm-dependent
  diffusivity angle secdiff, and the surface-reflection treatment
  (rrtmg_lw_rtrn.f90:239-589).  Optional dF/dT_s derivative (idrv,
  rrtmg_lw_rad.f90 + totplnkderiv tables).

DATA CAVEAT: the gas absorption k-tables (kao/kbo/selfrefo/forrefo/
fracref of rrtmg_lw_k_g.f90) are STRIPPED from the reference mirror and
unobtainable in this environment (tools/find_lw_ktables.py audits this).
This module therefore consumes surrogate k-distribution tables
(climt_tpu/data/rrtmg_lw_kdist_surrogate.npz, built by
tools/build_lw_surrogate_ktables.py and calibrated against the reference
regression caches by tools/calibrate_lw_ktables.py).  The PIPELINE is the
real RRTMG-LW algorithm; given AER's tables in the same npz layout it
reproduces the reference bit-for-bit to interpolation precision.  See
docs/RRTMG_LW_STATUS.md for measured accuracy.

Layout convention: layers bottom-up (index 0 = lowest), columns trailing,
g-points innermost: taug is (nz, ncol, 140).
"""

from __future__ import annotations

import functools
import os

import jax.numpy as jnp
import numpy as np
from jax import lax

from .interp import lin_rows, mix_rows, mix_rows_windowed
from ...ops.precision import dot_precision

_DATA_DIR = os.path.join(os.path.dirname(__file__), '..', '..', 'data')
_SUPPORT = os.path.join(_DATA_DIR, 'rrtmg_lw_support.npz')
_KDIST = os.path.join(_DATA_DIR, 'rrtmg_lw_kdist_surrogate.npz')

NBANDS = 16
NGPT = 140
# ngc (rrtmg_lw_init.f90 lwcmbdat)
NG = [10, 12, 16, 14, 16, 8, 12, 8, 12, 6, 8, 8, 4, 2, 2, 2]
NGS = np.concatenate([[0], np.cumsum(NG)])
NGB = np.concatenate([np.full(n, b) for b, n in enumerate(NG)])  # 0-based

ONEMINUS = 1.0 - 1.0e-6
AMD, AMW = 28.9660, 18.0160      # molecular weights (g/mol), inatm

# Pade transmittance lookup (rrtmg_lw_init.f90:100-125)
NTBL, PADE, EXPEPS = 10000, 0.278, 1.0e-20
BPADE = 1.0 / PADE
_t = np.arange(1, NTBL) / NTBL
TAU_TBL = np.concatenate([[0.0], BPADE * _t / (1.0 - _t), [1.0e10]])
EXP_TBL = np.concatenate(
    [[1.0], np.maximum(np.exp(-TAU_TBL[1:-1]), EXPEPS), [EXPEPS]])
with np.errstate(divide='ignore', invalid='ignore'):
    _tfn = 1.0 - 2.0 * (1.0 / TAU_TBL[1:-1]
                        - EXP_TBL[1:-1] / (1.0 - EXP_TBL[1:-1]))
TFN_TBL = np.concatenate(
    [[0.0], np.where(TAU_TBL[1:-1] < 0.06, TAU_TBL[1:-1] / 6.0, _tfn),
     [1.0]])

# Cloud band mapping icb/ipat for ncbands 1/5/16
# (rrtmg_lw_cldprop.f90:148-150 == rrtmg_lw_rtrn.f90:233-235)
ICB = np.array([[1] * 16,
                [1, 2, 3, 3, 3, 4, 4, 4, 5, 5, 5, 5, 5, 5, 5, 5],
                list(range(1, 17))]) - 1            # 0-based, (3, 16)

# Band definitions (rrtmg_lw_taumol.f90 taugb1-16 headers).  Keys:
#   lo/up: None | (species,) | (sp1, sp2, 'rat_pair') key species; the
#     two-species binary parameter uses the per-layer chi_mls ratio pair.
#   self/for: water-vapor continuum terms (for_up only in h2o-upper bands)
#   planck_lo/up: (sp1, sp2, refrat) for eta-dependent Planck fractions
#   minors_lo/up: [(gas, mode)] additive minor absorbers;
#     mode: 'n2' colbrd*scaleminorn2, 'plain' col*scaleminor,
#           'adjn2o' / ('adjco2', A, B, expo) empirically adjusted columns
#   wx_lo/up: [(cross_section, table)] CFC/CCL4 cross-section terms
#   corradj: band-specific pressure correction ('b1'|'b2'|None)
BANDS_LW = [
    dict(num=1, lo=('h2o',), up=('h2o',), self_lo=True, for_lo=True,
         for_up=True, minors_lo=[('n2', 'n2')], minors_up=[('n2', 'n2')],
         corradj='b1'),
    dict(num=2, lo=('h2o',), up=('h2o',), self_lo=True, for_lo=True,
         for_up=True, corradj='b2'),
    dict(num=3, lo=('h2o', 'co2', 'h2oco2'), up=('h2o', 'co2', 'h2oco2'),
         self_lo=True, for_lo=True, for_up=True,
         planck_lo=('h2o', 'co2', (1, 2, 9)),
         planck_up=('h2o', 'co2', (1, 2, 13)),
         minors_lo=[('n2o', 'adjn2o')], minors_up=[('n2o', 'adjn2o')]),
    dict(num=4, lo=('h2o', 'co2', 'h2oco2'), up=('o3', 'co2', 'o3co2'),
         self_lo=True, for_lo=True, for_up=False,
         planck_lo=('h2o', 'co2', (1, 2, 11)),
         planck_up=('o3', 'co2', (3, 2, 13))),
    dict(num=5, lo=('h2o', 'co2', 'h2oco2'), up=('o3', 'co2', 'o3co2'),
         self_lo=True, for_lo=True, for_up=False,
         planck_lo=('h2o', 'co2', (1, 2, 5)),
         planck_up=('o3', 'co2', (3, 2, 43)),
         minors_lo=[('o3', 'plain')], wx_lo=[('ccl4', 'ccl4')],
         wx_up=[('ccl4', 'ccl4')]),
    dict(num=6, lo=('h2o',), up=None, self_lo=True, for_lo=True,
         for_up=False,
         minors_lo=[('co2', ('adjco2', 2.0, 2.0, 0.77))],
         wx_lo=[('cfc11', 'cfc11adj'), ('cfc12', 'cfc12')],
         wx_up=[('cfc11', 'cfc11adj'), ('cfc12', 'cfc12')]),
    dict(num=7, lo=('h2o', 'o3', 'h2oo3'), up=('o3',),
         self_lo=True, for_lo=True, for_up=False,
         planck_lo=('h2o', 'o3', (1, 3, 3)),
         minors_lo=[('co2', ('adjco2', 3.0, 2.0, 0.79))],
         minors_up=[('co2', ('adjco2', 3.0, 2.0, 0.79))]),
    dict(num=8, lo=('h2o',), up=('o3',), self_lo=True, for_lo=True,
         for_up=False,
         minors_lo=[('co2', ('adjco2', 3.0, 2.0, 0.65)),
                    ('o3', 'plain'), ('n2o', 'plain')],
         minors_up=[('co2', ('adjco2', 3.0, 2.0, 0.65)),
                    ('n2o', 'plain')],
         wx_lo=[('cfc12', 'cfc12'), ('cfc22', 'cfc22adj')],
         wx_up=[('cfc12', 'cfc12'), ('cfc22', 'cfc22adj')]),
    dict(num=9, lo=('h2o', 'ch4', 'h2och4'), up=('ch4',),
         self_lo=True, for_lo=True, for_up=False,
         planck_lo=('h2o', 'ch4', (1, 6, 9)),
         minors_lo=[('n2o', 'adjn2o')], minors_up=[('n2o', 'adjn2o')]),
    dict(num=10, lo=('h2o',), up=('h2o',), self_lo=True, for_lo=True,
         for_up=True),
    dict(num=11, lo=('h2o',), up=('h2o',), self_lo=True, for_lo=True,
         for_up=True,
         minors_lo=[('o2', 'plain')], minors_up=[('o2', 'plain')]),
    dict(num=12, lo=('h2o', 'co2', 'h2oco2'), up=None,
         self_lo=True, for_lo=True, for_up=False,
         planck_lo=('h2o', 'co2', (1, 2, 10))),
    dict(num=13, lo=('h2o', 'n2o', 'h2on2o'), up=None,
         self_lo=True, for_lo=True, for_up=False,
         planck_lo=('h2o', 'n2o', (1, 4, 5)),
         minors_lo=[('co2', ('adjco2', 3.0, 2.0, 0.68)), ('co', 'plain')],
         minors_up=[('o3', 'plain')]),
    dict(num=14, lo=('co2',), up=('co2',), self_lo=True, for_lo=True,
         for_up=False),
    dict(num=15, lo=('n2o', 'co2', 'n2oco2'), up=None,
         self_lo=True, for_lo=True, for_up=False,
         planck_lo=('n2o', 'co2', (4, 2, 1)),
         minors_lo=[('n2', 'n2')]),
    dict(num=16, lo=('h2o', 'ch4', 'h2och4'), up=('ch4',),
         self_lo=True, for_lo=True, for_up=False,
         planck_lo=('h2o', 'ch4', (1, 6, 6))),
]

# chi_mls row (1-based Fortran) per species, rrlw_ref order
CHI_ROW = dict(h2o=1, co2=2, o3=3, n2o=4, co=5, ch4=6, o2=7)
# key-species eta ratio pairs used by BANDS_LW (per-layer, at jp and jp+1)
RAT_PAIRS = dict(h2oco2=('h2o', 'co2'), o3co2=('o3', 'co2'),
                 h2oo3=('h2o', 'o3'), h2och4=('h2o', 'ch4'),
                 h2on2o=('h2o', 'n2o'), n2oco2=('n2o', 'co2'))


_AER_KDIST = os.path.join(_DATA_DIR, 'rrtmg_lw_kdist_aer.npz')
_KDIST_OVERRIDE = [None]     # set by load_aer_tables


@functools.lru_cache()
def load_support():
    return dict(np.load(_SUPPORT))


def load_kdist():
    """Gas k-distribution tables.

    Preference order: (1) tables installed via ``load_aer_tables``,
    (2) a path in $CLIMT_TPU_LW_KTABLES, (3) the real AER tables dropped
    in as data/rrtmg_lw_kdist_aer.npz, (4) the calibrated surrogate.
    Given AER's data the pipeline reproduces the reference with no code
    change (docs/RRTMG_LW_STATUS.md)."""
    if _KDIST_OVERRIDE[0] is not None:
        return _KDIST_OVERRIDE[0]
    env = os.environ.get('CLIMT_TPU_LW_KTABLES')
    for path in (env, _AER_KDIST):
        if path and os.path.exists(path):
            _KDIST_OVERRIDE[0] = dict(np.load(path))
            return _KDIST_OVERRIDE[0]
    _KDIST_OVERRIDE[0] = dict(np.load(_KDIST))
    return _KDIST_OVERRIDE[0]


def load_aer_tables(path):
    """Install real AER RRTMG-LW k-tables for all subsequent calls.

    ``path`` must be an npz whose keys follow the surrogate layout
    (tools/build_lw_surrogate_ktables.py): per band ``b{n}_absa`` /
    ``b{n}_absb`` with rows flattened as (jp*5 + jt)*nspa + js (the
    Fortran ka/kb index order of rrtmg_lw_k_g.f90, g-points last),
    ``b{n}_selfref`` (10, ng), ``b{n}_forref`` (4, ng),
    ``b{n}_fracrefa``/``fracrefb`` ((ng,) or (ng, neta)),
    ``b{n}_k{a|b}_m{gas}`` minor-gas tables (19, ng), and the
    ``ccl4/cfc11adj/cfc12/cfc22adj`` cross-sections (ng,).
    Converting AER's published rrtmg_lw_k_g.f90 (or the netCDF release)
    into this layout is mechanical; parity then follows to
    interpolation precision with no code change."""
    _KDIST_OVERRIDE[0] = dict(np.load(path))
    return _KDIST_OVERRIDE[0]


def _trunc_int(x):
    return jnp.trunc(x).astype(jnp.int32)


def inatm_lw(play, plev, tlay, vmr, grav, avogad):
    """Column amounts per layer (molec/cm^2) and precipitable water.

    Mirrors rrtmg_lw_rad.nomcica.f90 inatm:743-844.  ``vmr`` maps species
    name -> volume mixing ratio w.r.t. dry air, (nz, ncol).
    """
    h2o = vmr['h2o']
    amm = (1.0 - h2o) * AMD + h2o * AMW
    dp = plev[:-1] - plev[1:]                       # mb, bottom-up
    coldry = dp * 1.0e3 * avogad / (1.0e2 * grav * amm * (1.0 + h2o))

    wkl = {gas: coldry * vmr[gas] for gas in vmr}
    summol = sum(vmr[g] for g in ('co2', 'o3', 'n2o', 'co', 'ch4', 'o2'))
    wbroad = coldry * (1.0 - summol)

    amttl = jnp.sum(coldry + wkl['h2o'], axis=0)
    wvttl = jnp.sum(wkl['h2o'], axis=0)
    wvsh = (AMW * wvttl) / (AMD * amttl)
    pwvcm = wvsh * (1.0e3 * plev[0]) / (1.0e2 * grav)
    return coldry, wkl, wbroad, pwvcm


def setcoef_lw(pavel, tavel, tz, tbound, semiss, coldry, wkl, wbroad,
               idrv=False):
    """Interpolation indices/factors and Planck values.

    Vectorized over (nz, ncol); mirrors rrtmg_lw_setcoef.f90:31-415.
    tz is (nz+1, ncol) interface temperature (tz[0] = lowest interface),
    tbound (ncol,) surface temperature, semiss (16, ncol).
    """
    t = load_support()
    dtype = pavel.dtype
    preflog = jnp.asarray(t['preflog'], dtype)
    tref = jnp.asarray(t['tref'], dtype)
    chi = jnp.asarray(t['chi_mls'], dtype)          # (7, 59)
    totplnk = jnp.asarray(t['totplnk'], dtype)      # (181, 16)
    stpfac = 296.0 / 1013.0

    plog = jnp.log(pavel)
    jp = jnp.clip(_trunc_int(36.0 - 5.0 * (plog + 0.04)), 1, 58)  # 1-based
    jp0 = jp - 1
    fp = 5.0 * (preflog[jp0] - plog)

    def t_index(jpx):
        jt = jnp.clip(_trunc_int(3.0 + (tavel - tref[jpx]) / 15.0), 1, 4)
        ft = (tavel - tref[jpx]) / 15.0 - (jt - 3)
        return jt - 1, ft                           # 0-based

    jt0, ft = t_index(jp0)
    jt10, ft1 = t_index(jp0 + 1)
    compfp = 1.0 - fp

    trop = plog > 4.56
    water = wkl['h2o'] / coldry
    scalefac = pavel * stpfac / tavel
    forfac_lo = scalefac / (1.0 + water)
    fac_lo = (332.0 - tavel) / 36.0
    indfor_lo = jnp.clip(_trunc_int(fac_lo), 1, 2)
    forfrac_lo = fac_lo - indfor_lo
    # stratosphere branch (setcoef.f90:345-370): indfor=3 fixed
    fac_up = (tavel - 188.0) / 36.0
    indfor = jnp.where(trop, indfor_lo, 3) - 1      # 0-based
    forfrac = jnp.where(trop, forfrac_lo, fac_up - 1.0)
    forfac = forfac_lo

    fac_s = (tavel - 188.0) / 7.2
    indself = jnp.clip(_trunc_int(fac_s) - 7, 1, 9) - 1  # 0-based
    selffrac = fac_s - (indself + 1 + 7)
    selffac = jnp.where(trop, water * forfac, 0.0)
    selffrac = jnp.where(trop, selffrac, 0.0)
    indself = jnp.where(trop, indself, 0)

    scaleminor = pavel / tavel
    scaleminorn2 = scaleminor * (wbroad / (coldry + wkl['h2o']))
    fac_m = (tavel - 180.8) / 7.2
    indminor = jnp.clip(_trunc_int(fac_m), 1, 18) - 1    # 0-based
    minorfrac = fac_m - (indminor + 1)

    cols = {'col' + g: 1.0e-20 * wkl[g] for g in wkl}
    # Fortran floors each molecular amount at 1e-32*coldry
    # (setcoef.f90:253-313) for co2/o3/n2o/ch4/o2/co
    for g in ('co2', 'o3', 'n2o', 'ch4', 'o2', 'co'):
        c = cols['col' + g]
        cols['col' + g] = jnp.where(c == 0.0, 1.0e-32 * coldry, c)
    cols['colbrd'] = 1.0e-20 * wbroad

    # per-layer chi ratios at jp and jp+1 for every key-species pair
    rats = {}
    for pair, (s1, s2) in RAT_PAIRS.items():
        r1, r2 = CHI_ROW[s1] - 1, CHI_ROW[s2] - 1
        rats['rat_' + pair] = chi[r1, jp0] / chi[r2, jp0]
        rats['rat_' + pair + '_1'] = chi[r1, jp0 + 1] / chi[r2, jp0 + 1]

    # --- integrated Planck values (setcoef.f90:160-280) ---
    def plnk_index(temp):
        ind = jnp.clip(_trunc_int(temp - 159.0), 1, 180)
        frac = temp - 159.0 - ind
        return ind - 1, frac                        # 0-based

    def plnk_interp(temp):
        ind, frac = plnk_index(temp)
        return lin_rows(totplnk, ind, frac)         # (..., 16)

    planklay = plnk_interp(tavel)                   # (nz, ncol, 16)
    planklev = plnk_interp(tz)                      # (nz+1, ncol, 16)
    plankbnd = semiss.T * plnk_interp(tbound)       # (ncol, 16)

    out = dict(
        trop=trop, jp=jp, jp0=jp0, jt0=jt0, jt10=jt10,
        fac00=compfp * (1.0 - ft), fac10=compfp * ft,
        fac01=fp * (1.0 - ft1), fac11=fp * ft1,
        selffac=selffac, selffrac=selffrac, indself=indself,
        forfac=forfac, forfrac=forfrac, indfor=indfor,
        scaleminor=scaleminor, scaleminorn2=scaleminorn2,
        indminor=indminor, minorfrac=minorfrac,
        coldry=coldry, chi=chi,
        planklay=planklay, planklev=planklev, plankbnd=plankbnd,
        **cols, **rats)
    if idrv:
        dplnk = jnp.asarray(load_support()['totplnkderiv'], dtype)
        ind, frac = plnk_index(tbound)
        lo, hi = dplnk[ind], dplnk[ind + 1]
        out['dplankbnd_dt'] = semiss.T * (lo + frac[..., None] * (hi - lo))
    return out


def _eta(specparm, n_eta):
    specmult = n_eta * jnp.minimum(specparm, ONEMINUS)
    js0 = _trunc_int(specmult)
    fs = specmult - js0
    return js0, fs


def _key_spec(spec, cs, suffix=''):
    """(speccomb, specparm) for a key-species tuple (per-layer chi rat)."""
    if spec is None:
        return None, None
    c1 = cs['col' + spec[0]]
    if len(spec) == 1:
        return c1, None
    rat = cs['rat_' + spec[2] + suffix]
    speccomb = c1 + rat * cs['col' + spec[1]]
    return speccomb, c1 / speccomb


def _adjusted_column(gas, mode, cs):
    """Empirically adjusted minor-gas column (taumol adjfac formulas)."""
    if mode == 'n2':
        return cs['colbrd'] * cs['scaleminorn2']
    col = cs['col' + gas]
    if mode == 'plain':
        return col * cs['scaleminor']
    chi = cs['chi']
    jp0 = cs['jp0']
    if mode == 'adjn2o':
        # rrtmg_lw_taumol.f90:525-535
        chi_ref = chi[CHI_ROW['n2o'] - 1, jp0 + 1]
        chi_lay = col / (1.0e-20 * cs['coldry'])
        rat = chi_lay / chi_ref
        adjfac = 0.5 + jnp.maximum(rat - 0.5, 1e-30) ** 0.65
        adj = adjfac * chi_ref * cs['coldry'] * 1.0e-20
        return jnp.where(rat > 1.5, adj, col)
    tag, thresh, base, expo = mode                  # ('adjco2', A, B, e)
    assert tag == 'adjco2'
    chi_ref = chi[CHI_ROW['co2'] - 1, jp0 + 1]
    chi_lay = col / (1.0e-20 * cs['coldry'])
    rat = chi_lay / chi_ref
    adjfac = base + jnp.maximum(rat - base, 1e-30) ** expo
    adj = adjfac * chi_ref * cs['coldry'] * 1.0e-20
    return jnp.where(rat > thresh, adj, col)


def taumol_lw(cs, wx, dtype, tables=None):
    """Gaseous optical depth and Planck fractions per g-point.

    Returns taug, fracs: (nz, ncol, 140).  Mirrors rrtmg_lw_taumol.f90
    taugb1-16 with the standard bilinear eta path (see module docstring).
    """
    t = load_kdist() if tables is None else tables
    trop = cs['trop']
    nz, ncol = trop.shape
    jp, jt0, jt10 = cs['jp'], cs['jt0'], cs['jt10']
    pavel = cs['pavel']

    taug_parts, fracs_parts = [], []
    for bi, bd in enumerate(BANDS_LW):
        num, ng = bd['num'], NG[bi]

        def tab(name, b=num):
            key = 'b%d_%s' % (b, name)
            return jnp.asarray(t[key], dtype) if key in t else None

        absa, absb = tab('absa'), tab('absb')
        have_lo = bd['lo'] is not None
        have_up = bd['up'] is not None
        nspa = 9 if (have_lo and len(bd['lo']) == 3) else (
            1 if have_lo else 0)
        nspb = 5 if (have_up and len(bd['up']) == 3) else (
            1 if have_up else 0)

        speccomb_l, specparm_l = _key_spec(bd['lo'], cs)
        speccomb_l1, specparm_l1 = _key_spec(bd['lo'], cs, '_1')
        speccomb_u, specparm_u = _key_spec(bd['up'], cs)
        speccomb_u1, specparm_u1 = _key_spec(bd['up'], cs, '_1')

        taug = jnp.zeros((nz, ncol, ng), dtype)

        # --- key-species interpolated absorption ------------------------
        if have_lo or have_up:
            zero_i = jnp.zeros_like(jp)
            zero_f = jnp.zeros(trop.shape, dtype)
            if have_lo:
                if specparm_l is not None:
                    jsl, fsl = _eta(specparm_l, 8)
                    jsl1, fsl1 = _eta(specparm_l1, 8)
                else:
                    jsl = jsl1 = zero_i
                    fsl = fsl1 = zero_f
                ind0a = (cs['jp0'] * 5 + jt0) * nspa + jsl
                ind1a = ((cs['jp0'] + 1) * 5 + jt10) * nspa + jsl1
            if have_up:
                if specparm_u is not None:
                    jsu, fsu = _eta(specparm_u, 4)
                    jsu1, fsu1 = _eta(specparm_u1, 4)
                else:
                    jsu = jsu1 = zero_i
                    fsu = fsu1 = zero_f
                ind0b = ((jp - 13) * 5 + jt0) * nspb + jsu
                ind1b = ((jp - 12) * 5 + jt10) * nspb + jsu1

            if have_lo and have_up:
                table = jnp.concatenate([absa, absb], axis=0)
                rows_a = absa.shape[0]
            elif have_lo:
                table, rows_a = absa, absa.shape[0]
            else:
                table, rows_a = absb, 0

            if have_lo and have_up:
                sc0 = jnp.where(trop, speccomb_l, speccomb_u)
                sc1 = jnp.where(trop, speccomb_l1, speccomb_u1)
            elif have_lo:
                sc0 = jnp.where(trop, speccomb_l, 0.0)
                sc1 = jnp.where(trop, speccomb_l1, 0.0)
            else:
                sc0 = jnp.where(trop, 0.0, speccomb_u)
                sc1 = jnp.where(trop, 0.0, speccomb_u1)

            # 8-term 2x2x2 (pressure, temperature, eta) interpolation as
            # sparse-weight dot contractions; the speccomb column
            # factors are folded into the term weights.  f32 splits the
            # regimes and contracts per-level table WINDOWS
            # (interp.mix_rows_windowed — at a fixed level jp spans <=2
            # of the 13/47 pressure blocks, so a 4-block window holds
            # every nonzero-weight row at 3-12x less dot and memory work);
            # f64 golden parity keeps the merged full-table path.
            use_window = dtype != jnp.float64
            terms = []
            terms_lo, terms_up = [], []
            for side, (f0name, f1name) in (
                    ('i0', ('fac00', 'fac10')), ('i1', ('fac01', 'fac11'))):
                sc = sc0 if side == 'i0' else sc1
                for fac_name, nsp_off in ((f0name, 0), (f1name, 1)):
                    fac = cs[fac_name]
                    for eta_off in (0, 1):
                        if have_lo:
                            fse = ((fsl if side == 'i0' else fsl1)
                                   if nspa == 9 else zero_f)
                            wl = fac * (fse if eta_off else (1.0 - fse))
                            il = ((ind0a if side == 'i0' else ind1a)
                                  + nsp_off * nspa
                                  + (eta_off if nspa == 9 else 0))
                        if have_up:
                            fse = ((fsu if side == 'i0' else fsu1)
                                   if nspb == 5 else zero_f)
                            wu = fac * (fse if eta_off else (1.0 - fse))
                            iu = ((ind0b if side == 'i0' else ind1b)
                                  + nsp_off * nspb
                                  + (eta_off if nspb == 5 else 0))
                        if nspa != 9 and nspb != 5 and eta_off:
                            continue        # eta term absent on both sides
                        if use_window:
                            if have_lo and not (eta_off and nspa != 9):
                                scl = (speccomb_l if side == 'i0'
                                       else speccomb_l1)
                                terms_lo.append(
                                    (il, jnp.where(trop, wl * scl, 0.0)))
                            if have_up and not (eta_off and nspb != 5):
                                scu = (speccomb_u if side == 'i0'
                                       else speccomb_u1)
                                terms_up.append(
                                    (iu, jnp.where(trop, 0.0, wu * scu)))
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
                        terms.append((idx, w * sc))
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
        if bd.get('self_lo') and selfref is not None:
            taug = taug + lin_rows(selfref, cs['indself'], cs['selffrac'],
                                   jnp.where(trop, cs['selffac'], 0.0))
        if (bd.get('for_lo') or bd.get('for_up')) and forref is not None:
            if bd.get('for_lo') and bd.get('for_up'):
                fmask = jnp.ones_like(trop)
            elif bd.get('for_lo'):
                fmask = trop
            else:
                fmask = ~trop
            taug = taug + lin_rows(forref, cs['indfor'], cs['forfrac'],
                                   jnp.where(fmask, cs['forfac'], 0.0))

        # --- minor absorbers ---------------------------------------------
        for region, key in (('lo', 'minors_lo'), ('up', 'minors_up')):
            for gas, mode in bd.get(key, ()):
                ktab = tab('k%s_m%s' % ('a' if region == 'lo' else 'b',
                                        gas))
                if ktab is None:
                    continue
                amount = _adjusted_column(gas, mode, cs)
                mask = trop if region == 'lo' else ~trop
                taug = taug + lin_rows(ktab, cs['indminor'],
                                       cs['minorfrac'],
                                       jnp.where(mask, amount, 0.0))

        # --- CFC/CCL4 cross-sections --------------------------------------
        for region, key in (('lo', 'wx_lo'), ('up', 'wx_up')):
            for gas, tname in bd.get(key, ()):
                xs = tab(tname)
                if xs is None or gas not in wx:
                    continue
                mask = trop if region == 'lo' else ~trop
                taug = taug + jnp.where(mask, wx[gas], 0.0)[..., None] * xs

        # --- band-specific pressure corrections (taugb1/taugb2) ----------
        if bd.get('corradj') == 'b1':
            corr_lo = jnp.where(pavel < 250.0,
                                1.0 - 0.15 * (250.0 - pavel) / 154.4, 1.0)
            corr_up = 1.0 - 0.15 * (pavel / 95.6)
            taug = taug * jnp.where(trop, corr_lo, corr_up)[..., None]
        elif bd.get('corradj') == 'b2':
            corr = 1.0 - 0.05 * (pavel - 100.0) / 900.0
            taug = taug * jnp.where(trop, corr, 1.0)[..., None]

        # --- Planck fractions ---------------------------------------------
        fraca, fracb = tab('fracrefa'), tab('fracrefb')

        def frac_interp(frtab, planck_spec, n_eta):
            if frtab.ndim == 1:
                return jnp.broadcast_to(frtab, (nz, ncol, ng))
            s1, s2, (r1, r2, lev) = planck_spec
            sup = load_support()
            refrat = (sup['chi_mls'][r1 - 1, lev - 1]
                      / sup['chi_mls'][r2 - 1, lev - 1])
            comb = cs['col' + s1] + refrat * cs['col' + s2]
            parm = jnp.minimum(cs['col' + s1] / comb, ONEMINUS)
            mult = n_eta * parm
            jpl = _trunc_int(mult)
            fpl = mult - jpl
            return lin_rows(frtab.T, jpl, fpl)      # (nz, ncol, ng)

        f_lo = (frac_interp(fraca, bd.get('planck_lo'), 8)
                if fraca is not None
                else jnp.zeros((nz, ncol, ng), dtype))
        f_up = (frac_interp(fracb, bd.get('planck_up'), 4)
                if fracb is not None else f_lo)
        fracs = jnp.where(trop[..., None], f_lo, f_up)

        taug_parts.append(taug)
        fracs_parts.append(fracs)

    return (jnp.concatenate(taug_parts, axis=-1),
            jnp.concatenate(fracs_parts, axis=-1))


def _cloud_abs_coeffs(iceflag, liqflag, ciwp, clwp, rei, rel, dtype):
    """Per-band ice/liquid mass absorption coefficients, already mapped
    through the icb pattern onto the 16 LW bands: (nz, ncol, 16) each.
    (rrtmg_lw_cldprop.f90:186-276; absice/absliq tables in-tree.)"""
    t = load_support()
    nz, ncol = ciwp.shape
    rei_safe = jnp.maximum(rei, 1.0e-20)
    if iceflag == 0:
        absice = (t['absice0'][0] + t['absice0'][1] / rei_safe)[..., None]
        absice = jnp.broadcast_to(absice, (nz, ncol, 16))
        ice_ncb = 1
    elif iceflag == 1:
        a = jnp.asarray(t['absice1'], dtype)        # (2, 5)
        absice = a[0] + a[1] / rei_safe[..., None]  # (nz, ncol, 5)
        ice_ncb = 5
    else:
        table = jnp.asarray(t['absice2' if iceflag == 2 else 'absice3'],
                            dtype)                  # (43|46, 16)
        nidx = table.shape[0]
        factor = (rei - 2.0) / 3.0
        index = jnp.clip(_trunc_int(factor), 1, nidx - 1)
        fint = factor - index
        lo = table[index - 1]
        hi = table[jnp.clip(index, 0, nidx - 1)]
        absice = lo + fint[..., None] * (hi - lo)
        ice_ncb = 16
    absice = jnp.where((ciwp > 0.0)[..., None], absice, 0.0)

    if liqflag == 0:
        absliq = jnp.broadcast_to(
            jnp.asarray(t['absliq0'], dtype), (nz, ncol, 1))
        liq_ncb = 1
    else:
        table = jnp.asarray(t['absliq1'], dtype)    # (58, 16)
        index = jnp.clip(_trunc_int(rel - 1.5), 1, 57)
        fint = rel - 1.5 - index
        lo = table[index - 1]
        hi = table[index]
        absliq = lo + fint[..., None] * (hi - lo)
        liq_ncb = 16
    absliq = jnp.where((clwp > 0.0)[..., None], absliq, 0.0)

    # map both onto the 16 bands through the icb pattern
    ice_ind = {1: 0, 5: 1, 16: 2}[ice_ncb]
    liq_ind = {1: 0, 16: 2}[liq_ncb]
    absice16 = absice[..., jnp.asarray(ICB[ice_ind], jnp.int32)]
    absliq16 = absliq[..., jnp.asarray(ICB[liq_ind], jnp.int32)]
    return absice16, absliq16


def _cloudy_mask(cldfrac, ciwp, clwp, tauc):
    cldmin = 1.0e-6
    cwp = ciwp + clwp
    tauctot = jnp.sum(tauc, axis=-1)
    return (cldfrac >= cldmin) & ((cwp >= cldmin) | (tauctot >= cldmin))


def cldprop_lw(inflag, iceflag, liqflag, cldfrac, tauc, ciwp, clwp,
               rei, rel, dtype):
    """Cloud optical depth per LW band, (nz, ncol, 16), already mapped
    through the icb/ipat band pattern so downstream transfer is uniform.

    Mirrors rrtmg_lw_cldprop.f90:154-283.  tauc is (nz, ncol, 16)
    direct-input optical depth."""
    t = load_support()
    cloudy = _cloudy_mask(cldfrac, ciwp, clwp, tauc)
    if inflag == 0:
        return jnp.where(cloudy[..., None], tauc, 0.0)
    if inflag == 1:
        tau = (float(t['abscld1']) * (ciwp + clwp))[..., None] \
            * jnp.ones(16, dtype)
        return jnp.where(cloudy[..., None], tau, 0.0)
    absice16, absliq16 = _cloud_abs_coeffs(
        iceflag, liqflag, ciwp, clwp, rei, rel, dtype)
    tau = ciwp[..., None] * absice16 + clwp[..., None] * absliq16
    return jnp.where(cloudy[..., None], tau, 0.0)


def cldprmc_lw(inflag, iceflag, liqflag, cldfmc, ciwpmc, clwpmc, taucmc,
               rei, rel, dtype):
    """Per-g-point McICA cloud optical depth (nz, ncol, 140)
    (rrtmg_lw_cldprmc.f90: same optics as cldprop applied per subcolumn).
    """
    ngb = jnp.asarray(NGB, jnp.int32)
    if inflag == 0:
        return taucmc
    if inflag == 1:
        t = load_support()
        return float(t['abscld1']) * (ciwpmc + clwpmc)
    # coefficient masks must see "any subcolumn has water", not g=0's
    absice16, absliq16 = _cloud_abs_coeffs(
        iceflag, liqflag, jnp.max(ciwpmc, -1), jnp.max(clwpmc, -1),
        rei, rel, dtype)
    return (ciwpmc * absice16[..., ngb]
            + clwpmc * absliq16[..., ngb])


def _tbl_lookup(od, use_tables=True):
    """(quantized_od, transmittance-complement a, tfn) via the Pade
    lookup tables (rrtmg_lw_rtrn.f90:352-441).  use_tables=False computes
    the same quantities analytically (smooth in od; used by the k-table
    calibration, which needs gradients through the optical depth)."""
    if not use_tables:
        od_safe = jnp.maximum(od, 1.0e-12)
        expo = jnp.exp(-od_safe)
        tfn = jnp.where(
            od_safe < 0.06, od_safe / 6.0,
            1.0 - 2.0 * (1.0 / od_safe - expo / (1.0 - expo)))
        return od, 1.0 - expo, tfn
    tblind = od / (BPADE + od)
    itr = _trunc_int(NTBL * tblind + 0.5)
    tau_tbl = jnp.asarray(TAU_TBL, od.dtype)
    exp_tbl = jnp.asarray(EXP_TBL, od.dtype)
    tfn_tbl = jnp.asarray(TFN_TBL, od.dtype)
    return tau_tbl[itr], 1.0 - exp_tbl[itr], tfn_tbl[itr]


def rtrn_impl(dtype, *, idrv=False, use_tables=True, per_g_cloud=False,
              backend=None):
    """Which LW flux sweep ``rtrn_lw`` runs: 'kernel' or 'plain'.

    The Pallas kernel (pallas_rtrn.py) covers float32, analytic
    transmittance, band clouds and no dF/dTs, and runs on the GPU only;
    every other case takes the plain XLA sweep.  ``backend`` defaults to
    ``jax.default_backend()``."""
    import jax
    backend = jax.default_backend() if backend is None else backend
    eligible = (dtype == jnp.float32 and not idrv and not use_tables
                and not per_g_cloud)
    return 'kernel' if eligible and backend == 'gpu' else 'plain'


def rtrn_lw(taug, fracs, planklay, planklev, plankbnd, semiss, pwvcm,
            cldfrac, taucld_band, pz, heatfac, idrv=False,
            dplankbnd_dt=None, per_g_cloud=False, use_tables=True,
            impl=None):
    """Random-overlap radiative transfer (rrtmg_lw_rtrn.f90:239-589).

    taug/fracs: (nz, ncol, 140); planklay (nz, ncol, 16);
    planklev (nz+1, ncol, 16); plankbnd/semiss (ncol, 16)/(16, ncol);
    taucld_band (nz, ncol, 16) band cloud optical depth (already through
    the ipat mapping), or per-g (nz, ncol, 140) when per_g_cloud=True
    (the McICA path, rrtmg_lw_rtrnmc.f90: cldfrac is then per-g 0/1).
    pz: (nz+1, ncol) interface pressure (mb).  Returns fluxes on
    interfaces (nz+1, ncol) and heating rates (nz, ncol, K/day).
    impl: 'plain', 'kernel', 'interpret' (the kernel in the Pallas
    interpreter), or None for ``rtrn_impl``'s choice.
    """
    t = load_support()
    dtype = taug.dtype
    nz, ncol = taug.shape[:2]
    ngb = jnp.asarray(NGB, jnp.int32)

    # diffusivity angle per band (rtrn.f90:260-268)
    a0 = jnp.asarray(t['secdiff_a0'], dtype)
    a1 = jnp.asarray(t['secdiff_a1'], dtype)
    a2 = jnp.asarray(t['secdiff_a2'], dtype)
    fixed = np.zeros(16, bool)
    fixed[[0, 3]] = True
    fixed[9:] = True
    sec = a0[:, None] + a1[:, None] * jnp.exp(a2[:, None] * pwvcm[None])
    sec = jnp.clip(sec, 1.5, 1.8)
    secdiff = jnp.where(jnp.asarray(fixed)[:, None], 1.66, sec)  # (16,ncol)
    secdiff_g = secdiff[ngb]                        # (140, ncol)

    wtdiff = float(t['wtdiff'][0])
    rec_6 = float(t['rec_6'][0])
    delwave = jnp.asarray(t['delwave'], dtype)
    fluxfac = np.pi * 2.0e4

    if impl is None:
        impl = rtrn_impl(dtype, idrv=idrv, use_tables=use_tables,
                         per_g_cloud=per_g_cloud)
    if impl != 'plain':
        from .pallas_rtrn import rtrn_lw_fused
        dwave_g = delwave[ngb] * wtdiff * fluxfac
        totuflux, totdflux, totuclfl, totdclfl = rtrn_lw_fused(
            taug, fracs, planklay, planklev, plankbnd, semiss, secdiff,
            cldfrac, taucld_band, dwave_g,
            ngb=tuple(int(b) for b in NGB), rec_6=rec_6,
            interpret=(impl == 'interpret'))
        fnet = totuflux - totdflux
        fnetc = totuclfl - totdclfl
        dpz = pz[:-1] - pz[1:]
        htr = heatfac * (fnet[:-1] - fnet[1:]) / dpz
        htrc = heatfac * (fnetc[:-1] - fnetc[1:]) / dpz
        return (totuflux, totdflux, htr, totuclfl, totdclfl, htrc)

    plfrac = jnp.moveaxis(fracs, -1, 0)             # (140, nz, ncol)
    odepth = jnp.maximum(
        jnp.moveaxis(secdiff_g[:, None] * jnp.moveaxis(taug, -1, 0), 0, 0),
        0.0)                                        # (140, nz, ncol)
    blay = planklay[..., NGB]                       # (nz, ncol, 140)
    blay = jnp.moveaxis(blay, -1, 0)                # (140, nz, ncol)
    bup = jnp.moveaxis(planklev[1:, :, :][..., NGB], -1, 0) - blay
    bdn = jnp.moveaxis(planklev[:-1, :, :][..., NGB], -1, 0) - blay

    if per_g_cloud:
        odcld = secdiff_g[:, None] * jnp.moveaxis(taucld_band, -1, 0)
        cldf = jnp.moveaxis(cldfrac, -1, 0)         # (140, nz, ncol)
    else:
        odcld = jnp.moveaxis(taucld_band, -1, 0)    # (16, nz, ncol)
        odcld = odcld * secdiff[:, None, :]
        odcld = odcld[ngb]                          # (140, nz, ncol)
        cldf = jnp.broadcast_to(cldfrac[None], odcld.shape)
    cloudy = cldf >= 1.0e-6
    odcld = jnp.where(cloudy, odcld, 0.0)

    # gas-only quantities with the od<0.06 quadratic/table split
    odt, a_tbl, tfn_tbl_g = _tbl_lookup(odepth, use_tables)
    small = odepth <= 0.06
    atrans = jnp.where(small, odepth - 0.5 * odepth * odepth, a_tbl)
    tfacgas = jnp.where(small, rec_6 * odepth, tfn_tbl_g)
    odepth_eff = jnp.where(small, odepth, odt)

    # total (gas+cloud) quantities
    odtot = odepth_eff + odcld
    _, atot_tbl, tfactot_tbl = _tbl_lookup(odtot, use_tables)
    small_tot = odtot < 0.06
    atot = jnp.where(small_tot, odtot - 0.5 * odtot * odtot, atot_tbl)
    tfactot = jnp.where(small_tot, rec_6 * odtot, tfactot_tbl)

    bbdgas = plfrac * (blay + tfacgas * bdn)
    bbugas = plfrac * (blay + tfacgas * bup)
    bbdtot = plfrac * (blay + tfactot * bdn)
    bbutot = plfrac * (blay + tfactot * bup)
    gassrc_dn = bbdgas * atrans
    gassrc_up = bbugas * atrans
    # effective cloud fraction: cldfrac * abscld, abscld = 1-exp(-odcld)
    # (rtrn.f90:301-313)
    abscld = 1.0 - jnp.exp(-odcld)
    efclfrac = jnp.where(cloudy, abscld * cldf, 0.0)

    def dn_step(radld, xs):
        atrans_l, gassrc_l, bbd_l, atot_l, bbdtot_l, ef_l, cf_l, cld_l = xs
        rad_cloudy = (radld - radld * (atrans_l + ef_l * (1.0 - atrans_l))
                      + gassrc_l + cf_l * (bbdtot_l * atot_l - gassrc_l))
        rad_clear = radld + (bbd_l - radld) * atrans_l
        radld = jnp.where(cld_l, rad_cloudy, rad_clear)
        return radld, radld

    zero = jnp.zeros((NGPT, ncol), dtype)
    # scan from top (lev nz-1) down to 0; drad[k] = radiance at interface k
    xs_dn = (atrans[:, ::-1], gassrc_dn[:, ::-1], bbdgas[:, ::-1],
             atot[:, ::-1], bbdtot[:, ::-1], efclfrac[:, ::-1],
             cldf[:, ::-1], cloudy[:, ::-1])
    xs_dn = tuple(jnp.moveaxis(x, 1, 0) for x in xs_dn)  # (nz, 140, ncol)
    radld_sfc, drad_rev = lax.scan(dn_step, zero, xs_dn)
    drad = drad_rev[::-1]                           # (nz, 140, ncol): iface k

    # clear-sky downward stream
    def dn_step_clear(radld, xs):
        atrans_l, bbd_l = xs
        radld = radld + (bbd_l - radld) * atrans_l
        return radld, radld

    xs_dnc = tuple(jnp.moveaxis(x[:, ::-1], 1, 0)
                   for x in (atrans, bbdgas))
    radclrd_sfc, cdrad_rev = lax.scan(dn_step_clear, zero, xs_dnc)
    cdrad = cdrad_rev[::-1]

    # surface source + reflection (rtrn.f90:460-476)
    fracs_sfc = jnp.moveaxis(fracs[0], -1, 0)       # (140, ncol)
    plankbnd_g = plankbnd.T[ngb]                    # (140, ncol)
    rad0 = fracs_sfc * plankbnd_g
    reflect = 1.0 - semiss[NGB]                     # (140, ncol)
    radlu0 = rad0 + reflect * radld_sfc
    radclru0 = rad0 + reflect * radclrd_sfc

    def up_step(radlu, xs):
        atrans_l, gassrc_l, bbutot_l, atot_l, ef_l, cf_l, cld_l, bbu_l = xs
        rad_cloudy = (radlu - radlu * (atrans_l + ef_l * (1.0 - atrans_l))
                      + gassrc_l + cf_l * (bbutot_l * atot_l - gassrc_l))
        rad_clear = radlu + (bbu_l - radlu) * atrans_l
        radlu = jnp.where(cld_l, rad_cloudy, rad_clear)
        return radlu, radlu

    xs_up = (atrans, gassrc_up, bbutot, atot, efclfrac, cldf, cloudy,
             bbugas)
    xs_up = tuple(jnp.moveaxis(x, 1, 0) for x in xs_up)
    _, urad_lev = lax.scan(up_step, radlu0, xs_up)  # (nz, 140, ncol)

    def up_step_clear(radlu, xs):
        atrans_l, bbu_l = xs
        radlu = radlu + (bbu_l - radlu) * atrans_l
        return radlu, radlu

    xs_upc = tuple(jnp.moveaxis(x, 1, 0) for x in (atrans, bbugas))
    _, curad_lev = lax.scan(up_step_clear, radclru0, xs_upc)

    # assemble interface radiances: index 0 = surface
    urad = jnp.concatenate([radlu0[None], urad_lev], axis=0)
    drad_full = jnp.concatenate([drad, zero[None]], axis=0)
    curad = jnp.concatenate([radclru0[None], curad_lev], axis=0)
    cdrad_full = jnp.concatenate([cdrad, zero[None]], axis=0)

    # each reduced g-point contributes its radiance plainly: the quadrature
    # weights are folded into the Planck fractions and the rwgt-reduced
    # absorption tables (rrtmg_lw_init.f90 cmbgb*)
    dwave_g = delwave[ngb] * wtdiff * fluxfac       # (140,)

    def to_flux(r):
        return jnp.einsum('lgc,g->lc', r, dwave_g,
                          precision=dot_precision('physics'))

    totuflux = to_flux(urad)
    totdflux = to_flux(drad_full)
    totuclfl = to_flux(curad)
    totdclfl = to_flux(cdrad_full)

    fnet = totuflux - totdflux
    fnetc = totuclfl - totdclfl
    # note rtrn.f90:584-585 zeroes htr(nlayers), but that is an EXTRA
    # slot beyond the model top: the driver returns hr(1:nlay) =
    # htr(0:nlay-1) (rrtmg_lw_rad.nomcica.f90 output mapping), so every
    # model layer keeps its computed heating rate
    dpz = pz[:-1] - pz[1:]
    htr = heatfac * (fnet[:-1] - fnet[1:]) / dpz
    htrc = heatfac * (fnetc[:-1] - fnetc[1:]) / dpz

    out = (totuflux, totdflux, htr, totuclfl, totdclfl, htrc)
    if idrv:
        # dF_up/dT_s (rtrn.f90: idrv blocks): transmitted surface term
        d_rad0 = fracs_sfc * dplankbnd_dt.T[ngb]
        trans_cloudy = (1.0 - atot) * cldf + (1.0 - atrans) * (1.0 - cldf)
        trans_layer = jnp.where(cloudy, trans_cloudy, 1.0 - atrans)
        trans_clear = 1.0 - atrans

        def dup_step(carry, xs):
            t_l, tc_l = xs
            d_lu, d_clru = carry
            d_lu = d_lu * t_l
            d_clru = d_clru * tc_l
            return (d_lu, d_clru), (d_lu, d_clru)

        xs_d = tuple(jnp.moveaxis(x, 1, 0)
                     for x in (trans_layer, trans_clear))
        _, (d_urad_lev, d_curad_lev) = lax.scan(
            dup_step, (d_rad0, d_rad0), xs_d)
        d_urad = jnp.concatenate([d_rad0[None], d_urad_lev], axis=0)
        d_curad = jnp.concatenate([d_rad0[None], d_curad_lev], axis=0)
        out = out + (to_flux(d_urad), to_flux(d_curad))
    return out


@functools.lru_cache()
def _gpt_weights():
    """Combined quadrature weight per reduced g-point (sum of wt over the
    original g-points merged into it) -- used by the McICA path where each
    g-point carries its own subcolumn."""
    t = load_support()
    wt, ngn = t['wt'], t['ngn'].astype(int)
    w = np.zeros(NGPT)
    ipr = 0
    for ig, n in enumerate(ngn):
        for _ in range(n):
            w[ig] += wt[ipr % 16]
            ipr += 1
    return w


def rrtmg_lw_fluxes(play, plev, tlay, tlev, tsfc, h2ovmr, o3vmr, co2vmr,
                    ch4vmr, n2ovmr, o2vmr, cfc11vmr, cfc12vmr, cfc22vmr,
                    ccl4vmr, emis, cldfrac, taucld, ciwp, clwp, rei, rel,
                    tauaer, grav, avogad, cpdair, inflag=2, iceflag=1,
                    liqflag=1, idrv=False, per_g_cloud=False,
                    cldfrac_g=None, taucld_g=None, tables=None,
                    use_tables=True, sweep=None):
    """Full LW pipeline: inatm -> setcoef -> taumol -> cldprop -> rtrn.

    All profile arrays are (nz, ncol) bottom-up, plev/tlev (nz+1, ncol),
    tsfc (ncol,), emis (16, ncol), taucld/tauaer (nz, ncol, 16).
    Mirrors the rrtmg_lw driver (rrtmg_lw_rad.nomcica.f90:439-560).
    When per_g_cloud=True, cldfrac_g/taucld_g (nz, ncol, 140) McICA
    subcolumns are used instead of cldfrac/taucld (rrtmg_lw_rad.f90).
    sweep: ``rtrn_lw``'s ``impl`` (None: ``rtrn_impl`` decides).

    Returns (uflx, dflx, hr, uflxc, dflxc, hrc[, duflx_dt, duflxc_dt]):
    fluxes (nz+1, ncol) W/m^2, heating rates (nz, ncol) K/day.
    """
    dtype = play.dtype
    vmr = dict(h2o=h2ovmr, co2=co2vmr, o3=o3vmr, n2o=n2ovmr,
               co=jnp.zeros_like(play), ch4=ch4vmr, o2=o2vmr)
    coldry, wkl, wbroad, pwvcm = inatm_lw(play, plev, tlay, vmr, grav,
                                          avogad)
    # cross-section amounts (molec/cm^2 * 1e-20), inatm:836-840
    wx = {name: coldry * v * 1.0e-20
          for name, v in (('ccl4', ccl4vmr), ('cfc11', cfc11vmr),
                          ('cfc12', cfc12vmr), ('cfc22', cfc22vmr))}

    cs = setcoef_lw(play, tlay, tlev, tsfc, emis, coldry, wkl, wbroad,
                    idrv=idrv)
    cs['pavel'] = play
    taug, fracs = taumol_lw(cs, wx, dtype, tables=tables)
    # aerosol optical depth per band added to every g-point of the band
    # (rrtmg_lw_rad.nomcica.f90: taut = taug + tauaer)
    taug = taug + tauaer[..., NGB]

    heatfac = grav * 8.64e4 / (cpdair * 1.0e2)

    if per_g_cloud:
        return rtrn_lw(taug, fracs, cs['planklay'], cs['planklev'],
                       cs['plankbnd'], emis, pwvcm, cldfrac_g, taucld_g,
                       plev, heatfac, idrv=idrv,
                       dplankbnd_dt=cs.get('dplankbnd_dt'),
                       per_g_cloud=True, use_tables=use_tables,
                       impl=sweep)

    taucld_band = cldprop_lw(inflag, iceflag, liqflag, cldfrac,
                             taucld, ciwp, clwp, rei, rel, dtype)
    return rtrn_lw(taug, fracs, cs['planklay'], cs['planklev'],
                   cs['plankbnd'], emis, pwvcm, cldfrac, taucld_band,
                   plev, heatfac, idrv=idrv,
                   dplankbnd_dt=cs.get('dplankbnd_dt'),
                   use_tables=use_tables, impl=sweep)
