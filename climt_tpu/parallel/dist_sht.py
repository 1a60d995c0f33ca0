"""Distributed spherical-harmonic transform: lat-local FFT <-> m-local
Legendre with an all_to_all transpose.

This is the climate-model analog of Ulysses-style sequence parallelism
(SURVEY.md §2.5/§5): the horizontal grid is sharded over latitude bands,
so the zonal FFT is device-local; the Legendre transform needs ALL
latitudes per zonal wavenumber m, so the Fourier coefficients are
transposed with one ``all_to_all`` per direction — after which each
device owns a block of m and performs its Legendre matmuls locally, and
the spectral state is SHARDED over m (not replicated).

Collective volume per transform over an L-device 'lat' axis:
  all_to_all moves (L-1)/L of the Fourier tensor
  = (batch x nlat x ceil(M+1, L) x 16 bytes) per device pair direction —
  e.g. T85, nz=28: 28 x 128 x 88 complex64 ≈ 2.5 MB/device/transform,
  over NVLink between the GPUs of a host.  Compute per device drops by L
  for both the FFT (nlat/L rows) and the Legendre matmuls (M/L block),
  and the spectral state memory by L.

``DistributedSHT`` implements the FULL transform surface of
``ops.sht.SphericalHarmonicTransform`` (analyze/synthesize, derivative
synthesis, vector vorticity-divergence analysis, u,v recovery, gradient,
Laplacian algebra), so ``dycore.SpectralDycore(..., mesh=...)`` swaps it
in as a drop-in and the production semi-implicit step runs with
m-sharded spectral state — every per-n implicit solve and per-m algebra
op is wavenumber-local, so only the transforms communicate.  Numerics
are identical to the single-device transform (the same precomputed
tensors, sliced per device); equivalence is asserted in
tests/test_dist_sht.py and tests/test_multichip.py on the forced
8-device CPU mesh.

Spectral layout: (nz, M_padded, N+1) with M padded up to a multiple of
the number of lat-devices; rows m >= truncation+1 are identically zero
(the triangular mask is zero there).

Multi-host: call ``climt_tpu.parallel.initialize_distributed()`` first
(jax.distributed), then build the mesh over ``jax.devices()`` spanning
all hosts; XLA hands the all_to_all to NCCL (NVLink within a host, the
network across hosts).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import NamedSharding, PartitionSpec as P

from ..ops.precision import dot_precision
from ..ops.sht import SphericalHarmonicTransform


def _shmap(body, mesh, in_specs, out_specs):
    return jax.shard_map(body, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=False)


def _rank3(fn):
    """Promote rank-2 (single-field) args to the rank-3 batched layout
    the shard_map bodies expect, squeezing the outputs back."""
    def wrapped(*arrays):
        squeeze = arrays[0].ndim == 2
        if squeeze:
            arrays = tuple(a[None] for a in arrays)
        out = fn(*arrays)
        if squeeze:
            if isinstance(out, tuple):
                out = tuple(o[0] for o in out)
            else:
                out = out[0]
        return out
    return wrapped


class DistributedSHT:
    """m-parallel spherical harmonic transform over a mesh 'lat' axis.

    Wraps a single-device ``SphericalHarmonicTransform`` (same
    truncation, tensors, conventions); grid fields are lat-sharded
    (nz, nlat, nlon), spectral fields m-sharded (nz, M_padded, N+1).
    All public transform methods are shard_map-composable: call them
    inside an enclosing jit (the production fused step) or stand-alone.
    """

    def __init__(self, sht: SphericalHarmonicTransform, mesh,
                 axis='lat'):
        self.sht = sht
        self.mesh = mesh
        self.axis = axis
        self.L = mesh.shape[axis]
        if sht.nlat % self.L:
            raise ValueError('nlat %d not divisible by %d lat-devices'
                             % (sht.nlat, self.L))
        M = sht.truncation + 1
        self.m_pad = (-M) % self.L          # pad m so blocks are even
        self.M_padded = M + self.m_pad
        self.m_block = self.M_padded // self.L
        self.lat_block = sht.nlat // self.L

        # mirrored single-device attributes (drop-in surface)
        self.nlon = sht.nlon
        self.nlat = sht.nlat
        self.truncation = sht.truncation
        self.radius = sht.radius
        self.dtype = sht.dtype
        self.cdtype = sht.cdtype
        self.mu = sht.mu
        self.weights = sht.weights
        self.fft_impl = sht.fft_impl

        # per-m constant arrays padded to M_padded rows.  n-dependent
        # eigenvalue arrays replicate their row; the triangular mask is
        # zero in the padded rows (they carry no coefficients).
        def pad_rows(a, fill='edge'):
            a = np.asarray(a)
            if not self.m_pad:
                return jnp.asarray(a)
            if fill == 'edge':
                return jnp.asarray(np.pad(a, ((0, self.m_pad), (0, 0)),
                                          mode='edge'))
            return jnp.asarray(np.pad(a, ((0, self.m_pad), (0, 0))))

        self.n_2d = pad_rows(sht.n_2d)
        self.mask = pad_rows(sht.mask, fill='zero')
        self.laplacian_eig = pad_rows(sht.laplacian_eig)
        self.inv_laplacian_eig = pad_rows(sht.inv_laplacian_eig)
        self.m_1d = jnp.asarray(np.arange(self.M_padded))

        # per-device m-blocks of the Legendre tensors, zero-padded:
        # (L, m_block, N+1, nlat)
        def blocks(tensor):
            t = np.asarray(tensor)
            t = np.pad(t, ((0, self.m_pad), (0, 0), (0, 0)))
            return jnp.asarray(
                t.reshape(self.L, self.m_block, *t.shape[1:]))

        self._P_blocks = blocks(sht.P)
        self._H_blocks = blocks(sht.H)
        self._Pw_blocks = blocks(sht.Pw)
        self._Pw_c2_blocks = blocks(sht.Pw_over_cos2)
        self._Hw_c2_blocks = blocks(sht.Hw_over_cos2)

        # local triangular mask per device block: (L, m_block, N+1)
        m_all = np.arange(self.M_padded)
        n_all = np.arange(sht.truncation + 1)
        mask = ((n_all[None, :] >= m_all[:, None])
                & (m_all[:, None] <= sht.truncation))
        self._mask_blocks = jnp.asarray(
            mask.reshape(self.L, self.m_block, -1).astype(np.float64),
            dtype=sht.dtype)
        self._m_local = jnp.asarray(
            m_all.reshape(self.L, self.m_block).astype(np.float64),
            dtype=sht.dtype)
        coslat = np.sqrt(1.0 - np.asarray(sht.mu) ** 2)
        self._coslat_blocks = jnp.asarray(
            coslat.reshape(self.L, self.lat_block), dtype=sht.dtype)

        self.grid_spec = P(None, axis, None)
        self.spec_spec = P(None, axis, None)

    def grid_sharding(self):
        return NamedSharding(self.mesh, self.grid_spec)

    def spec_sharding(self):
        return NamedSharding(self.mesh, self.spec_spec)

    # -- building blocks (run inside shard_map) ---------------------------
    def _fourier_to_lat(self, fm):
        """(nz, nlat/L, M) m-full lat-block -> (nz, nlat, m_block)."""
        if self.m_pad:
            fm = jnp.pad(fm, ((0, 0), (0, 0), (0, self.m_pad)))
        return lax.all_to_all(fm, self.axis, split_axis=2, concat_axis=1,
                              tiled=True)

    def _lat_to_fourier(self, fm):
        """(nz, nlat, m_block) -> (nz, nlat/L, M) m-full lat-block."""
        fm = lax.all_to_all(fm, self.axis, split_axis=1, concat_axis=2,
                            tiled=True)
        if self.m_pad:
            fm = fm[..., :self.truncation + 1]
        return fm

    def _contract_analysis(self, tensor_blocks, fm, idx):
        """einsum('mnl,zlm->zmn') with the device's tensor block."""
        t = tensor_blocks[idx]
        prec = dot_precision('spectral')
        re = jnp.einsum('mnl,zlm->zmn', t, fm.real, precision=prec)
        im = jnp.einsum('mnl,zlm->zmn', t, fm.imag, precision=prec)
        return lax.complex(re, im)

    def _contract_synthesis(self, tensor_blocks, spec, idx):
        """einsum('mnl,zmn->zlm') with the device's tensor block."""
        t = tensor_blocks[idx]
        prec = dot_precision('spectral')
        re = jnp.einsum('mnl,zmn->zlm', t, spec.real, precision=prec)
        im = jnp.einsum('mnl,zmn->zlm', t, spec.imag, precision=prec)
        return lax.complex(re, im)

    # -- shard_map bodies --------------------------------------------------
    def _analyze_body(self, grid_block):
        """grid (nz, nlat/L, nlon) -> spec block (nz, m_block, N+1)."""
        idx = lax.axis_index(self.axis)
        fm = self._fourier_to_lat(self.sht._fft(grid_block))
        spec = self._contract_analysis(self._Pw_blocks, fm, idx)
        return spec * self._mask_blocks[idx][None]

    def _synthesize_body(self, spec_block):
        """spec block (nz, m_block, N+1) -> grid (nz, nlat/L, nlon)."""
        idx = lax.axis_index(self.axis)
        fm = self._contract_synthesis(self._P_blocks, spec_block, idx)
        return self.sht._ifft(self._lat_to_fourier(fm))

    def _synthesize_dmu_body(self, spec_block):
        idx = lax.axis_index(self.axis)
        fm = self._contract_synthesis(self._H_blocks, spec_block, idx)
        return self.sht._ifft(self._lat_to_fourier(fm))

    def _im_local(self, idx):
        """i * m for the device's m block, complex, (1, m_block, 1)."""
        m = self._m_local[idx]
        return lax.complex(jnp.zeros_like(m), m)[None, :, None]

    def _gradient_body(self, spec_block):
        """spec block -> (ddx, ddy) grid blocks, one fused transpose."""
        idx = lax.axis_index(self.axis)
        im = self._im_local(idx)
        fm_x = self._contract_synthesis(
            self._P_blocks, spec_block * im, idx)
        fm_y = self._contract_synthesis(self._H_blocks, spec_block, idx)
        fm = self._lat_to_fourier(jnp.concatenate([fm_x, fm_y], axis=0))
        g = self.sht._ifft(fm)
        nz = spec_block.shape[0]
        acos = (self.radius * self._coslat_blocks[idx])[None, :, None]
        return g[:nz] / acos, g[nz:] / acos

    def _uv_body(self, vort_block, div_block):
        """(vort, div) m-blocks -> (u, v) grid blocks, fused transpose.

        psi = inv_lap(zeta), chi = inv_lap(D);
        u cos = (1/a)[d chi/d lambda - (1-mu^2) d psi/d mu],
        v cos = (1/a)[d psi/d lambda + (1-mu^2) d chi/d mu].
        """
        idx = lax.axis_index(self.axis)
        inv = self.inv_laplacian_eig[:self.m_block][None]  # m-independent
        psi = vort_block * inv
        chi = div_block * inv
        im = self._im_local(idx)
        fm_u = (self._contract_synthesis(self._P_blocks, chi * im, idx)
                - self._contract_synthesis(self._H_blocks, psi, idx))
        fm_v = (self._contract_synthesis(self._P_blocks, psi * im, idx)
                + self._contract_synthesis(self._H_blocks, chi, idx))
        fm = self._lat_to_fourier(jnp.concatenate([fm_u, fm_v], axis=0))
        g = self.sht._ifft(fm)
        nz = vort_block.shape[0]
        acos = (self.radius * self._coslat_blocks[idx])[None, :, None]
        return g[:nz] / acos, g[nz:] / acos

    def _vort_div_body(self, A_block, B_block):
        """(U, V) = (u cos, v cos) lat-blocks -> (curl, div) m-blocks.

        zeta_nm = (1/a)[ i m Q[V] + QH[U] ],
        D_nm    = (1/a)[ i m Q[U] - QH[V] ]  (ops/sht.py conventions).
        """
        idx = lax.axis_index(self.axis)
        nz = A_block.shape[0]
        fm = self._fourier_to_lat(self.sht._fft(
            jnp.concatenate([A_block, B_block], axis=0)))
        fmA, fmB = fm[:nz], fm[nz:]
        im = self._im_local(idx)
        QA = self._contract_analysis(self._Pw_c2_blocks, fmA, idx)
        QB = self._contract_analysis(self._Pw_c2_blocks, fmB, idx)
        QHA = self._contract_analysis(self._Hw_c2_blocks, fmA, idx)
        QHB = self._contract_analysis(self._Hw_c2_blocks, fmB, idx)
        mask = self._mask_blocks[idx][None]
        curl = (im * QB + QHA) / self.radius * mask
        div = (im * QA - QHB) / self.radius * mask
        return curl, div

    # -- public API --------------------------------------------------------
    @functools.cached_property
    def analyze(self):
        """(nz, nlat, nlon) lat-sharded -> (nz, M_padded, N+1) m-sharded."""
        return _rank3(_shmap(self._analyze_body, self.mesh,
                             (self.grid_spec,), self.spec_spec))

    @functools.cached_property
    def synthesize(self):
        return _rank3(_shmap(self._synthesize_body, self.mesh,
                             (self.spec_spec,), self.grid_spec))

    @functools.cached_property
    def synthesize_dmu(self):
        """Grid field of (1 - mu^2) d/dmu."""
        return _rank3(_shmap(self._synthesize_dmu_body, self.mesh,
                             (self.spec_spec,), self.grid_spec))

    def synthesize_dlambda(self, spec):
        """Zonal derivative: the i*m multiply is m-local."""
        m = self.m_1d.astype(self.dtype)
        im = lax.complex(jnp.zeros_like(m), m)
        return self.synthesize(spec * im[:, None])

    @functools.cached_property
    def gradient(self):
        """Grid (d/dx, d/dy) of a spectral field."""
        return _rank3(_shmap(
            self._gradient_body, self.mesh,
            (self.spec_spec,), (self.grid_spec, self.grid_spec)))

    @functools.cached_property
    def uv_from_vort_div(self):
        return _rank3(_shmap(
            self._uv_body, self.mesh,
            (self.spec_spec, self.spec_spec),
            (self.grid_spec, self.grid_spec)))

    @functools.cached_property
    def vort_div_analysis(self):
        return _rank3(_shmap(
            self._vort_div_body, self.mesh,
            (self.grid_spec, self.grid_spec),
            (self.spec_spec, self.spec_spec)))

    def laplacian(self, spec):
        return spec * self.laplacian_eig

    def inverse_laplacian(self, spec):
        return spec * self.inv_laplacian_eig

    def filter_spec(self, spec):
        return spec * self.mask

    @property
    def total_wavenumber(self):
        return self.n_2d

    def pad_spec(self, spec):
        """Pad a replicated (nz, M, N+1) spectral array to M_padded (the
        sharded layout's m extent)."""
        if self.m_pad:
            return jnp.pad(spec, ((0, 0), (0, self.m_pad), (0, 0)))
        return spec

    def unpad_spec(self, spec):
        M = self.sht.truncation + 1
        return spec[:, :M, :]
