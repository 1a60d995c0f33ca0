"""Precision of the hot path's matrix products, chosen in one place.

On the GPU a float32 dot at DEFAULT precision may run in TF32 (about
three decimal digits), which the CPU never does, so every dot of the
float32 path names its precision here, by what it computes:

- 'spectral': Legendre and zonal-DFT transforms (ops/sht.py,
  parallel/dist_sht.py) and the vertical level coupling of the
  semi-implicit step (dycore/spectral_dynamics.py).  Few flops per step.
- 'physics': flux quadrature and optics sums in radiation and the
  entrainment matrices of Emanuel convection.  Few flops per step.
- 'table': the taumol one-hot table contraction
  (components/rrtmg/interp.py), the one flop-heavy dot of the step.

Each choice below was measured against float64 on an H100 (700 W) with
``tools/variant_sweep.py``, which times and checks the alternatives.
"""

from __future__ import annotations

from jax import lax

PRECISION = {
    # full float32.  DEFAULT (TF32 on the H100) puts the T85 moist GCM
    # 1.5 K and 1.9 m/s off float64 after 12 steps, over chip_smoke.py's
    # limits; TF32_TF32_F32_X3 passes but runs no faster (0.3%, within
    # noise) and the CPU refuses it.
    'spectral': lax.Precision.HIGHEST,
    'physics': lax.Precision.HIGHEST,
    # three bf16 passes: as accurate as HIGHEST against float64 (LW
    # fluxes within 8e-4 W/m2 instead of 0.1 W/m2 at DEFAULT) and as fast
    # as DEFAULT (25 ms per 60x8192 radiation call against 30 ms at
    # HIGH or HIGHEST); a single bf16 pass is over the radiation limits.
    'table': lax.DotAlgorithmPreset.BF16_BF16_F32_X3,
}


def dot_precision(kind):
    """The ``precision`` argument for a dot of the given kind."""
    return PRECISION[kind]
