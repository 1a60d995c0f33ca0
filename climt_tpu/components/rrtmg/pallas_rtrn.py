"""LW flux sweep (rtrn) as one Pallas kernel on the Triton route.

``lw_spectral.rtrn_lw`` (after rrtmg_lw_rtrn.f90:239-589) is a
first-order recurrence over layers, independent for every (g-point,
column).  Its plain XLA form materializes ~18 (140, nz, ncol) float32
intermediates in device memory and runs each layer sweep as a device
while-loop.  Here the recurrence lives in registers:

- one program per (column block, g block): BLOCK_G = 16 g-points, so the
  140 g-points fill 9 blocks whose 4 padded lanes carry zero weight;
- both sweeps are in-kernel loops over layers.  Transmittances and
  sources are recomputed in the up-sweep rather than staged, so device
  memory sees taug/fracs read twice plus the band-indexed inputs;
- band -> g selection is an index load of the band-indexed inputs;
- every g block writes partial flux sums to (n_gblk, nz+1, ncol) outputs
  that XLA adds: no atomics, so results are deterministic.

Scope: float32, analytic transmittance (use_tables=False), band clouds,
no dF/dTs.  ``lw_spectral.rtrn_impl`` picks this kernel on the GPU for
that configuration and the plain sweep everywhere else.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

BLOCK_G = 16
BLOCK_C = 64
NUM_WARPS = 4


def _rtrn_kernel(tg_ref, fr_ref, plk_ref, plv_ref, pbnd_ref, sem_ref,
                 secd_ref, cf_ref, tcl_ref, ngb_ref, dw_ref,
                 outu_ref, outd_ref, outuc_ref, outdc_ref,
                 *, nz, ncol, ngpt, rec_6, block_c):
    """One (column block, g block) program: down then up sweep."""
    f32 = jnp.float32
    shape = (block_c, BLOCK_G)
    ic = pl.program_id(0)
    jg = pl.program_id(1)
    c0 = ic * block_c
    g0 = jg * BLOCK_G
    cvec = jnp.minimum(c0 + jnp.arange(block_c, dtype=jnp.int32), ncol - 1)
    gvec = jnp.minimum(g0 + jnp.arange(BLOCK_G, dtype=jnp.int32), ngpt - 1)
    cc = jnp.broadcast_to(cvec[:, None], shape)
    gg = jnp.broadcast_to(gvec[None, :], shape)
    # padded g lanes read band 0 and have zero weight, so they add nothing
    bb = jnp.broadcast_to(ngb_ref[pl.ds(g0, BLOCK_G)][None, :], shape)
    dw = dw_ref[pl.ds(g0, BLOCK_G)][None, :]
    sec = secd_ref[bb, cc]
    ocols = pl.ds(c0, block_c)

    def layer(z, zlev):
        """Transmittances and sources of layer z; zlev is its
        downstream interface (z for the down sweep, z+1 for the up)."""
        # quadrature weight folded into the Planck fraction: every source
        # term, hence every radiance, is proportional to it
        fr = fr_ref[z, cc, gg] * dw
        od = jnp.maximum(tg_ref[z, cc, gg] * sec, 0.0)
        od_safe = jnp.maximum(od, 1.0e-12)
        expo = jnp.exp(-od_safe)
        small = od <= 0.06
        atrans = jnp.where(small, od - 0.5 * od * od, 1.0 - expo)
        tfacgas = jnp.where(
            small, rec_6 * od,
            1.0 - 2.0 * (1.0 / od_safe - expo / (1.0 - expo)))
        cf = cf_ref[z, cvec][:, None]
        cloudy = cf >= 1.0e-6
        odcld = jnp.where(cloudy, tcl_ref[z, cc, bb] * sec, 0.0)
        odtot = od + odcld
        odtot_safe = jnp.maximum(odtot, 1.0e-12)
        expt = jnp.exp(-odtot_safe)
        small_t = odtot < 0.06
        atot = jnp.where(small_t, odtot - 0.5 * odtot * odtot, 1.0 - expt)
        tfactot = jnp.where(
            small_t, rec_6 * odtot,
            1.0 - 2.0 * (1.0 / odtot_safe - expt / (1.0 - expt)))
        efcl = jnp.where(cloudy, (1.0 - jnp.exp(-odcld)) * cf, 0.0)
        aeff = atrans + efcl * (1.0 - atrans)
        blay = plk_ref[z, cc, bb]
        db = plv_ref[zlev, cc, bb] - blay
        gsrc = fr * (blay + tfacgas * db) * atrans
        src = jnp.where(
            cloudy, gsrc + cf * (fr * (blay + tfactot * db) * atot - gsrc),
            gsrc)
        return atrans, aeff, gsrc, src

    def gsum(r):
        return jnp.sum(r, axis=1)

    zero_c = jnp.zeros((block_c,), f32)
    outd_ref[jg, nz, ocols] = zero_c                 # nothing enters at TOA
    outdc_ref[jg, nz, ocols] = zero_c

    def dn_body(t, carry):
        rad, radc = carry
        z = nz - 1 - t
        atrans, aeff, gsrc, src = layer(z, z)
        rad = rad * (1.0 - aeff) + src
        radc = radc * (1.0 - atrans) + gsrc
        outd_ref[jg, z, ocols] = gsum(rad)
        outdc_ref[jg, z, ocols] = gsum(radc)
        return rad, radc

    zero = jnp.zeros(shape, f32)
    rad, radc = jax.lax.fori_loop(0, nz, dn_body, (zero, zero))

    # surface emission + reflection (rtrn.f90:460-476)
    rad0 = fr_ref[0, cc, gg] * dw * pbnd_ref[cc, bb]
    reflect = 1.0 - sem_ref[bb, cc]
    radu = rad0 + reflect * rad
    raduc = rad0 + reflect * radc
    outu_ref[jg, 0, ocols] = gsum(radu)
    outuc_ref[jg, 0, ocols] = gsum(raduc)

    def up_body(z, carry):
        radu, raduc = carry
        atrans, aeff, gsrc, src = layer(z, z + 1)
        radu = radu * (1.0 - aeff) + src
        raduc = raduc * (1.0 - atrans) + gsrc
        outu_ref[jg, z + 1, ocols] = gsum(radu)
        outuc_ref[jg, z + 1, ocols] = gsum(raduc)
        return radu, raduc

    jax.lax.fori_loop(0, nz, up_body, (radu, raduc))


@functools.partial(jax.jit, static_argnames=(
    'ngb', 'rec_6', 'block_c', 'interpret'))
def rtrn_lw_fused(taug, fracs, planklay, planklev, plankbnd, semiss,
                  secdiff, cldfrac, taucld_band, dwave_g, *, ngb, rec_6,
                  block_c=BLOCK_C, interpret=False):
    """Fluxes (totuflux, totdflux, totuclfl, totdclfl), each (nz+1, ncol),
    weighted by ``dwave_g`` (the caller folds fluxfac into it).

    taug/fracs (nz, ncol, ngpt); planklay (nz, ncol, 16); planklev
    (nz+1, ncol, 16); plankbnd (ncol, 16); semiss/secdiff (16, ncol);
    cldfrac (nz, ncol); taucld_band (nz, ncol, 16); dwave_g (ngpt,);
    ngb: tuple, band of each g-point; rec_6: the small-depth source
    factor; block_c: columns per program.  ``interpret`` runs the kernel
    in the Pallas interpreter.
    """
    f32 = jnp.float32
    nz, ncol, ngpt = taug.shape
    n_gblk = -(-ngpt // BLOCK_G)
    n_cblk = -(-ncol // block_c)
    gpad = n_gblk * BLOCK_G - ngpt
    ngb_p = jnp.asarray(np.pad(np.asarray(ngb, np.int32), (0, gpad)))
    dw_p = jnp.pad(dwave_g.astype(f32), (0, gpad))

    kernel = functools.partial(_rtrn_kernel, nz=nz, ncol=ncol, ngpt=ngpt,
                               rec_6=rec_6, block_c=block_c)
    out_shape = [jax.ShapeDtypeStruct((n_gblk, nz + 1, n_cblk * block_c),
                                      f32)] * 4
    outs = pl.pallas_call(
        kernel,
        grid=(n_cblk, n_gblk),
        out_shape=out_shape,
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name='rtrn_lw_sweep',
    )(taug, fracs, planklay, planklev, plankbnd, semiss, secdiff,
      cldfrac, taucld_band, ngb_p, dw_p)
    return tuple(jnp.sum(o, axis=0)[:, :ncol] for o in outs)
