"""Error and time of the float32 path's variants on the GPU.

    python tools/variant_sweep.py [--table P ...] [--spectral P ...]

- each candidate precision of ops/precision.py's 'table' kind: standalone
  LW+SW radiation at 60 levels x 8192 columns against the float64
  golden-parity path, under the limits of tests/test_radiation_fastpath.py,
  and its time per call;
- each candidate for the 'spectral' and 'physics' kinds together: 12 steps
  of the T85 moist GCM against float64 from the same state, and the time
  of 12 steps;
- the T85 moist GCM with the plain XLA LW sweep instead of the Pallas
  kernel (lw_spectral.rtrn_impl), at the default precisions.

Candidates are lax.Precision or lax.DotAlgorithmPreset names.  All
programs compile concurrently, then run one at a time; one line each.
"""

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

TABLE = ['DEFAULT', 'HIGH', 'HIGHEST', 'BF16_BF16_F32', 'BF16_BF16_F32_X3',
         'TF32_TF32_F32', 'TF32_TF32_F32_X3']
SPECTRAL = ['DEFAULT', 'HIGHEST', 'TF32_TF32_F32_X3']


def resolve(name):
    from jax import lax
    if hasattr(lax.Precision, name):
        return getattr(lax.Precision, name)
    return getattr(lax.DotAlgorithmPreset, name)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--table', nargs='*', default=TABLE)
    parser.add_argument('--spectral', nargs='*', default=SPECTRAL)
    args = parser.parse_args()

    import chip_smoke as cs
    from bench import build_radiation_bench
    from climt_tpu.components.rrtmg import lw_spectral
    from climt_tpu.dycore.moist_gcm import build_moist_gcm
    from climt_tpu.ops import precision
    from climt_tpu.utils.compile_cache import enable_compile_cache
    from climt_tpu.utils.device import card_line, require_gpu
    card = card_line()
    import jax
    import jax.numpy as jnp
    import numpy as np
    require_gpu(jax.devices())
    enable_compile_cache(REPO)
    cs.say(card)
    default = dict(precision.PRECISION)
    progs = cs.Programs(card)

    def add(name, thunk, f64=False):
        try:
            progs.add(name, thunk, f64)
        except Exception as err:        # a preset this backend refuses
            cs.say('%-26s refused: %s' % (name, str(err)[:300]))

    with cs.x64():
        rad64, x64 = build_radiation_bench(60, 8192, dtype=jnp.float64,
                                           use_tables=True)
    progs.add('rad_f64', lambda: rad64.lower(x64), f64=True)
    x32 = build_radiation_bench(60, 8192)[1]
    for name in args.table:
        precision.PRECISION.update(default, table=resolve(name))
        add('table=' + name,
            lambda: build_radiation_bench(60, 8192)[0].lower(x32))

    carry0 = build_moist_gcm(dtype=jnp.float32, **cs.T85)[1]()
    carry64 = cs.to_f64(carry0)
    progs.add('moist_f64', lambda: build_moist_gcm(
        dtype=jnp.float64, **cs.T85)[3].lower(carry64, cs.N_STEPS),
        f64=True)
    for name in args.spectral:
        p = resolve(name)
        precision.PRECISION.update(default, spectral=p, physics=p)
        add('spectral=' + name, lambda: build_moist_gcm(
            dtype=jnp.float32, **cs.T85)[3].lower(carry0, cs.N_STEPS))
    precision.PRECISION.update(default)
    kernel_choice = lw_spectral.rtrn_impl
    lw_spectral.rtrn_impl = lambda *a, **k: 'plain'
    progs.add('sweep=plain', lambda: build_moist_gcm(
        dtype=jnp.float32, **cs.T85)[3].lower(carry0, cs.N_STEPS))
    lw_spectral.rtrn_impl = kernel_choice
    progs.add('sweep=kernel', lambda: build_moist_gcm(
        dtype=jnp.float32, **cs.T85)[3].lower(carry0, cs.N_STEPS))

    progs.compile_all(allow_fail=True)

    with cs.x64():
        _, rad64 = cs.timed(progs['rad_f64'], x64)
        rad64 = {k: np.asarray(v) for k, v in rad64.items()}
        _, m64 = cs.timed(progs['moist_f64'], carry64)
        m64 = {k: np.asarray(v) for k, v in cs.moist_fields(*m64).items()}
    for name in progs.lowered:
        if name.endswith('f64') or name not in progs.compiled:
            continue
        compiled = progs[name]
        if name.startswith('table='):
            compiled(x32)
            call_s, out = cs.timed(compiled, x32, repeats=5)
            ref, tol, what = rad64, cs.RAD_TOL, 's/call'
        else:
            _, out = cs.timed(compiled, carry0)
            call_s, _ = cs.timed(compiled, out[0])
            out = cs.moist_fields(*out)
            ref, tol, what = m64, cs.MOIST_TOL, 's/12 steps'
        errs = {k: cs.max_diff(out[k], ref[k])[0] for k in tol}
        ok = all(errs[k] <= tol[k] for k in errs)
        cs.say('%-26s %.6f %s  %s  %s  [%s]'
               % (name, call_s, what,
                  ' '.join('%s=%.3e' % kv for kv in errs.items()),
                  'within limits' if ok else 'OVER LIMITS', card))

    # the sweep A/B once more in turns (kernel, plain, plain, kernel)
    if 'sweep=plain' in progs.compiled and 'sweep=kernel' in progs.compiled:
        for name in ('sweep=kernel', 'sweep=plain', 'sweep=plain',
                     'sweep=kernel'):
            call_s, _ = cs.timed(progs[name], carry0, repeats=5)
            cs.say('%-26s %.6f s/12 steps (mean of 5)  [%s]'
                   % (name, call_s, card))


if __name__ == '__main__':
    main()
