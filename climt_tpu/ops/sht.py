"""Spherical harmonic transforms on the Gaussian grid.

The reference's GFS dynamical core used SHTns + FFTW for its spectral
transforms (ghost build refs at /root/reference/climt/_lib/Makefile:1-16; the
dycore itself was split out of the tree, HISTORY.rst:5-8).  This module is
the JAX equivalent: the Legendre transform is a batched matmul over
latitude and the zonal transform is an
RFFT, with all coefficient tensors precomputed once in float64 and cast to
the compute dtype.

Conventions:
- Triangular truncation T: spectral coefficients a[m, n] for
  0 <= m <= T, m <= n <= T (dense (T+1, T+1) arrays with an upper-triangular
  mask; the ~2x dense compute is cheaper than packed layouts).
- Associated Legendre functions P̄_n^m(mu) normalized so that
  (1/2) ∫ P̄_n^m(mu)^2 dmu = 1 (CAM/GFS convention).
- Grid fields are real (..., nlat, nlon); synthesis is
  g = irfft_m( sum_n a[m, n] P̄_n^m(mu) ), analysis the Gaussian-quadrature
  adjoint.
- H̄_n^m = (1 - mu^2) dP̄_n^m/dmu is precomputed for derivative transforms
  and integration-by-parts curl/divergence analysis.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core.grid import gauss_legendre_nodes
from .precision import dot_precision


def _legendre_tensors(truncation, mu):
    """P̄[m, n, lat] and H̄[m, n, lat] in float64 numpy.

    Uses the standard stable recurrences: diagonal seed
    P̄_m^m = sqrt((2m+1)/(2m)) cos(phi) P̄_{m-1}^{m-1}, off-diagonal
    three-term recurrence with eps_n^m = sqrt((n^2-m^2)/(4n^2-1)), and the
    derivative identity
    (1-mu^2) dP̄_n^m/dmu = (n+1) eps_n^m P̄_{n-1}^m - n eps_{n+1}^m P̄_{n+1}^m.
    """
    T = truncation
    nlat = mu.shape[0]
    sin_phi = mu
    cos_phi = np.sqrt(1.0 - mu ** 2)

    # need P up to degree T+1 for the derivative identity
    N = T + 1
    P = np.zeros((T + 1, N + 1, nlat))

    def eps(n, m):
        return np.sqrt((n ** 2 - m ** 2) / (4.0 * n ** 2 - 1.0))

    # diagonal
    P[0, 0] = 1.0
    for m in range(1, T + 1):
        P[m, m] = np.sqrt((2.0 * m + 1.0) / (2.0 * m)) * cos_phi * P[m - 1,
                                                                     m - 1]
    # first off-diagonal
    for m in range(0, T + 1):
        if m + 1 <= N:
            P[m, m + 1] = np.sqrt(2.0 * m + 3.0) * sin_phi * P[m, m]
    # remaining degrees
    for m in range(0, T + 1):
        for n in range(m + 2, N + 1):
            P[m, n] = (sin_phi * P[m, n - 1]
                       - eps(n - 1, m) * P[m, n - 2]) / eps(n, m)

    H = np.zeros((T + 1, T + 1, nlat))
    for m in range(0, T + 1):
        for n in range(m, T + 1):
            term = -n * eps(n + 1, m) * P[m, n + 1]
            if n - 1 >= m:
                term = term + (n + 1.0) * eps(n, m) * P[m, n - 1]
            H[m, n] = term
    return P[:, :T + 1, :], H


class SphericalHarmonicTransform:
    """Batched-matmul spherical harmonic transform for one resolution."""

    def __init__(self, nlon, nlat, truncation=None, radius=6.371e6,
                 dtype=jnp.float64, fft_impl='fft'):
        """``fft_impl``: 'fft' uses the backend FFT; 'matmul' evaluates the
        (truncated) zonal DFT as real matmuls — required under sharding on
        the CPU backend (whose FFT thunk rejects non-default layouts) and
        an alternative to the FFT for moderate nlon."""
        self.fft_impl = fft_impl
        self._needs_dft_matrices = fft_impl == 'matmul'
        if truncation is None:
            # alias-free triangular truncation for both directions:
            # nlat >= (3T+1)/2 and nlon >= 3T+1
            truncation = min((2 * nlat - 1) // 3, (nlon - 1) // 3)
        self.nlon = nlon
        self.nlat = nlat
        self.truncation = truncation
        self.radius = radius

        mu, w = gauss_legendre_nodes(nlat)
        # grid convention: latitude index 0 = northernmost
        # (gaussian_latitudes returns north->south = descending latitude),
        # i.e. mu descending
        mu = mu[::-1].copy()
        w = w[::-1].copy()
        self.mu = mu
        self.weights = w

        P, H = _legendre_tensors(truncation, mu)
        cdtype = jnp.complex64 if dtype == jnp.float32 else jnp.complex128
        self.dtype = dtype
        self.cdtype = cdtype
        self.P = jnp.asarray(P, dtype=dtype)             # (M, N, lat)
        self.H = jnp.asarray(H, dtype=dtype)
        # analysis quadrature tensors (weights folded in)
        self.Pw = jnp.asarray(P * (w / 2.0), dtype=dtype)
        self.Hw = jnp.asarray(H * (w / 2.0), dtype=dtype)
        self.Pw_over_cos2 = jnp.asarray(
            P * (w / (2.0 * (1.0 - mu ** 2))), dtype=dtype)
        self.Hw_over_cos2 = jnp.asarray(
            H * (w / (2.0 * (1.0 - mu ** 2))), dtype=dtype)

        n = np.arange(truncation + 1)
        m = np.arange(truncation + 1)
        self.n_2d = jnp.asarray(np.broadcast_to(n[None, :],
                                                (truncation + 1,
                                                 truncation + 1)))
        self.m_1d = jnp.asarray(m)
        # spectral mask: n >= m
        self.mask = jnp.asarray(
            (n[None, :] >= m[:, None]).astype(np.float64), dtype=dtype)
        # Laplacian eigenvalues -n(n+1)/a^2
        lap = -n * (n + 1.0) / radius ** 2
        self.laplacian_eig = jnp.asarray(
            np.broadcast_to(lap[None, :],
                            (truncation + 1, truncation + 1)), dtype=dtype)
        inv = np.zeros(truncation + 1)
        inv[1:] = -radius ** 2 / (n[1:] * (n[1:] + 1.0))
        self.inv_laplacian_eig = jnp.asarray(
            np.broadcast_to(inv[None, :],
                            (truncation + 1, truncation + 1)), dtype=dtype)

        if self._needs_dft_matrices:
            self._build_dft_matrices()

    # -- zonal (Fourier) stage ------------------------------------------------
    def _build_dft_matrices(self):
        """Precompute (at construction, never inside a trace) the real
        matmul factors of the truncated zonal DFT."""
        n = self.nlon
        m = np.arange(self.truncation + 1)
        j = np.arange(n)
        theta = 2.0 * np.pi * np.outer(j, m) / n         # (nlon, M+1)
        self._dft_cos = jnp.asarray(np.cos(theta) / n, dtype=self.dtype)
        self._dft_sin = jnp.asarray(-np.sin(theta) / n, dtype=self.dtype)
        w = np.full(self.truncation + 1, 2.0)
        w[0] = 1.0
        self._idft_cos = jnp.asarray(
            (np.cos(theta) * w[None, :]).T, dtype=self.dtype)
        self._idft_sin = jnp.asarray(
            (np.sin(theta) * w[None, :]).T, dtype=self.dtype)

    def _dft_matrices(self):
        return self._dft_cos, self._dft_sin, self._idft_cos, self._idft_sin

    def _fft(self, grid):
        """(..., nlat, nlon) -> (..., nlat, M+1) complex Fourier coeffs."""
        if self.fft_impl == 'matmul':
            c, s, _, _ = self._dft_matrices()
            prec = dot_precision('spectral')
            re = jnp.einsum('...j,jm->...m', grid, c, precision=prec)
            im = jnp.einsum('...j,jm->...m', grid, s, precision=prec)
            return jax.lax.complex(re, im)
        fm = jnp.fft.rfft(grid, axis=-1) / self.nlon
        return fm[..., :self.truncation + 1]

    def _ifft(self, fm):
        """(..., nlat, M+1) -> (..., nlat, nlon) real grid."""
        if self.fft_impl == 'matmul':
            _, _, ic, is_ = self._dft_matrices()
            prec = dot_precision('spectral')
            return (jnp.einsum('...m,mj->...j', fm.real, ic,
                               precision=prec)
                    - jnp.einsum('...m,mj->...j', fm.imag, is_,
                                 precision=prec))
        nfreq = self.nlon // 2 + 1
        pad = [(0, 0)] * (fm.ndim - 1) + [(0, nfreq - fm.shape[-1])]
        fm_full = jnp.pad(fm, pad)
        return jnp.fft.irfft(fm_full * self.nlon, n=self.nlon, axis=-1)

    # -- real-valued Legendre contractions ------------------------------------
    # Real and imaginary parts are contracted separately, so every
    # Legendre transform is a real batched matmul (a complex dot_general
    # would cost four real products and rides no fast library path).
    @staticmethod
    def _contract_analysis(tensor, fm):
        """einsum('mnl,...lm->...mn') with real tensor, complex fm."""
        prec = dot_precision('spectral')
        re = jnp.einsum('mnl,...lm->...mn', tensor, fm.real,
                        precision=prec)
        im = jnp.einsum('mnl,...lm->...mn', tensor, fm.imag,
                        precision=prec)
        return jax.lax.complex(re, im)

    @staticmethod
    def _contract_synthesis(tensor, spec):
        """einsum('mnl,...mn->...lm') with real tensor, complex spec."""
        prec = dot_precision('spectral')
        re = jnp.einsum('mnl,...mn->...lm', tensor, spec.real,
                        precision=prec)
        im = jnp.einsum('mnl,...mn->...lm', tensor, spec.imag,
                        precision=prec)
        return jax.lax.complex(re, im)

    # -- full transforms ------------------------------------------------------
    def analyze(self, grid):
        """Grid (..., nlat, nlon) -> spectral (..., M+1, N+1) complex."""
        fm = self._fft(grid)                       # (..., lat, m)
        return self._contract_analysis(self.Pw, fm) * self.mask

    def synthesize(self, spec):
        """Spectral (..., M+1, N+1) -> grid (..., nlat, nlon)."""
        fm = self._contract_synthesis(self.P, spec)
        return self._ifft(fm)

    def synthesize_dlambda(self, spec):
        """Zonal derivative: grid field of (1/(1-mu^2)) ... note: returns
        plain ∂g/∂lambda on the grid."""
        im = 1j * self.m_1d.astype(self.dtype)
        return self.synthesize(spec * im[:, None])

    def synthesize_dmu(self, spec):
        """Grid field of (1 - mu^2) ∂g/∂mu."""
        fm = self._contract_synthesis(self.H, spec)
        return self._ifft(fm)

    # -- vector calculus ------------------------------------------------------
    def uv_from_vort_div(self, vort_spec, div_spec):
        """Grid (u, v) from spectral vorticity and divergence.

        psi = inv_lap(zeta), chi = inv_lap(D);
        u cos = (1/a)[d chi/d lambda - (1-mu^2) d psi/d mu],
        v cos = (1/a)[d psi/d lambda + (1-mu^2) d chi/d mu].
        """
        psi = vort_spec * self.inv_laplacian_eig
        chi = div_spec * self.inv_laplacian_eig
        u_cos = (self.synthesize_dlambda(chi)
                 - self.synthesize_dmu(psi)) / self.radius
        v_cos = (self.synthesize_dlambda(psi)
                 + self.synthesize_dmu(chi)) / self.radius
        cos2 = (1.0 - self.mu ** 2)
        coslat = jnp.asarray(np.sqrt(cos2), dtype=self.dtype)[:, None]
        return u_cos / coslat, v_cos / coslat

    def vort_div_analysis(self, A_grid, B_grid):
        """Spectral (curl-like, div-like) pair from grid (A, B) = (U, V)
        with U = u cos(phi), V = v cos(phi):

        zeta_nm = (1/a)[ i m Q[V] + QH[A=U] ]
        D_nm    = (1/a)[ i m Q[U] - QH[V] ]

        where Q is quadrature with weight w/(2(1-mu^2)) against P̄ and QH the
        same against H̄ (integration by parts of the mu-derivative).
        """
        fmA = self._fft(A_grid)
        fmB = self._fft(B_grid)
        im = (1j * self.m_1d.astype(self.dtype))[:, None]
        QA = self._contract_analysis(self.Pw_over_cos2, fmA)
        QB = self._contract_analysis(self.Pw_over_cos2, fmB)
        QHA = self._contract_analysis(self.Hw_over_cos2, fmA)
        QHB = self._contract_analysis(self.Hw_over_cos2, fmB)
        curl = (im * QB + QHA) / self.radius * self.mask
        div = (im * QA - QHB) / self.radius * self.mask
        return curl, div

    def gradient(self, spec):
        """Grid (d/dx, d/dy) of a spectral field: (1/(a cos)) d/dlambda and
        (cos/a) d/dmu."""
        cos2 = (1.0 - self.mu ** 2)
        coslat = jnp.asarray(np.sqrt(cos2), dtype=self.dtype)[:, None]
        ddx = self.synthesize_dlambda(spec) / self.radius / coslat
        ddy = self.synthesize_dmu(spec) / self.radius / coslat
        return ddx, ddy

    def laplacian(self, spec):
        return spec * self.laplacian_eig

    def inverse_laplacian(self, spec):
        return spec * self.inv_laplacian_eig

    def filter_spec(self, spec):
        """Apply the triangular truncation mask."""
        return spec * self.mask

    @property
    def total_wavenumber(self):
        return self.n_2d
