"""The LW flux-sweep kernel (components/rrtmg/pallas_rtrn.py) against the
plain XLA sweep, and the choice between them.

On the CPU the kernel runs in the Pallas interpreter, which executes the
same kernel logic the Triton route compiles for the GPU.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from climt_tpu.components.rrtmg import lw_spectral as L
from climt_tpu.components.rrtmg.pallas_rtrn import rtrn_lw_fused

HEATFAC = 9.80665 * 8.64e4 / (1004.64 * 1e2)


def _rtrn_inputs(nz=9, ncol=40):
    rng = np.random.RandomState(1)
    f32 = jnp.float32
    taug = jnp.asarray(rng.rand(nz, ncol, L.NGPT) * 2.0, f32)
    fracs = jnp.asarray(rng.rand(nz, ncol, L.NGPT), f32)
    planklay = jnp.asarray(rng.rand(nz, ncol, 16) * 0.2, f32)
    planklev = jnp.asarray(rng.rand(nz + 1, ncol, 16) * 0.2, f32)
    plankbnd = jnp.asarray(rng.rand(ncol, 16) * 0.2, f32)
    semiss = jnp.asarray(0.9 + 0.1 * rng.rand(16, ncol), f32)
    pwvcm = jnp.asarray(rng.rand(ncol) * 4, f32)
    cldfrac = jnp.asarray(
        (rng.rand(nz, ncol) > 0.5) * rng.rand(nz, ncol), f32)
    taucld_band = jnp.asarray(rng.rand(nz, ncol, 16) * 3.0, f32)
    pz = jnp.asarray(np.linspace(1000., 1., nz + 1)[:, None]
                     * np.ones((1, ncol)), f32)
    return (taug, fracs, planklay, planklev, plankbnd, semiss, pwvcm,
            cldfrac, taucld_band, pz)


@pytest.mark.parametrize('nz', [7, 28])
def test_rtrn_fused_matches_xla(nz):
    """Kernel fluxes against the plain sweep; ncol=40 is not a multiple
    of the column block, and 140 g-points leave a part-filled g block."""
    (taug, fracs, planklay, planklev, plankbnd, semiss, pwvcm,
     cldfrac, taucld_band, pz) = _rtrn_inputs(nz=nz)
    ref = L.rtrn_lw(taug, fracs, planklay, planklev, plankbnd, semiss,
                    pwvcm, cldfrac, taucld_band, pz, HEATFAC,
                    use_tables=False, impl='plain')
    totu_r, totd_r, _, totuc_r, totdc_r, _ = ref

    t = L.load_support()
    f32 = jnp.float32
    a0 = jnp.asarray(t['secdiff_a0'], f32)
    a1 = jnp.asarray(t['secdiff_a1'], f32)
    a2 = jnp.asarray(t['secdiff_a2'], f32)
    fixed = np.zeros(16, bool)
    fixed[[0, 3]] = True
    fixed[9:] = True
    sec = jnp.clip(a0[:, None] + a1[:, None]
                   * jnp.exp(a2[:, None] * pwvcm[None]), 1.5, 1.8)
    secdiff = jnp.where(jnp.asarray(fixed)[:, None], 1.66, sec)
    dwave_g = (jnp.asarray(t['delwave'], f32)[jnp.asarray(L.NGB)]
               * float(t['wtdiff'][0]) * (np.pi * 2.0e4))

    totu, totd, totuc, totdc = rtrn_lw_fused(
        taug, fracs, planklay, planklev, plankbnd, semiss, secdiff,
        cldfrac, taucld_band, dwave_g,
        ngb=tuple(int(b) for b in L.NGB), rec_6=float(t['rec_6'][0]),
        block_c=16, interpret=True)
    for a, b in ((totu, totu_r), (totd, totd_r), (totuc, totuc_r),
                 (totdc, totdc_r)):
        assert a.shape == b.shape == (nz + 1, 40)
        scale = np.abs(np.asarray(b)).max()
        assert np.abs(np.asarray(a) - np.asarray(b)).max() < 2e-6 * scale


def test_rtrn_dispatch_routes_through_kernel():
    """rtrn_lw with the kernel (interpreted) agrees with the plain sweep
    in every output, heating rates included."""
    (taug, fracs, planklay, planklev, plankbnd, semiss, pwvcm,
     cldfrac, taucld_band, pz) = _rtrn_inputs(nz=7, ncol=24)
    args = (taug, fracs, planklay, planklev, plankbnd, semiss, pwvcm,
            cldfrac, taucld_band, pz, HEATFAC)
    ref = L.rtrn_lw(*args, use_tables=False, impl='plain')
    out = L.rtrn_lw(*args, use_tables=False, impl='interpret')
    assert len(out) == len(ref)
    for a, b in zip(out, ref):
        scale = max(np.abs(np.asarray(b)).max(), 1e-6)
        assert np.abs(np.asarray(a) - np.asarray(b)).max() < 5e-6 * scale


@pytest.mark.parametrize('backend, dtype, kw, expected', [
    ('gpu', jnp.float32, dict(use_tables=False), 'kernel'),
    ('gpu', jnp.float64, dict(use_tables=False), 'plain'),
    ('gpu', jnp.float32, dict(use_tables=True), 'plain'),
    ('gpu', jnp.float32, dict(use_tables=False, per_g_cloud=True), 'plain'),
    ('gpu', jnp.float32, dict(use_tables=False, idrv=True), 'plain'),
    ('cpu', jnp.float32, dict(use_tables=False), 'plain'),
])
def test_rtrn_impl_choice(backend, dtype, kw, expected):
    assert L.rtrn_impl(dtype, backend=backend, **kw) == expected


def test_rtrn_impl_default_backend_here():
    """Under the test suite's CPU backend the default choice is the plain
    sweep: the interpreter is never picked implicitly."""
    assert L.rtrn_impl(jnp.float32, use_tables=False) == 'plain'
