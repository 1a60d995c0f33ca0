"""Smoke run of the main path on one NVIDIA GPU, checked against plain
references.

    python chip_smoke.py           # phases a-f on one card
    python chip_smoke.py --four    # m-sharded T85 GCM on four cards only

a  device: refuses to run unless JAX's first device is a GPU; prints the
   device, JAX version, XLA_FLAGS and the card's name and power limit.
b  T85 moist GCM (256x128x28, float32, radiation every 6 steps) through
   build_moist_gcm's init_fn and run_fn: 12 steps, compile time, time of
   a second 12-step call, memory; every field finite and bounded.
c  the same 12 steps in float64 from the same initial state (exact row
   gathers, plain flux sweep): float32 against float64.
d  standalone LW+SW radiation at 60 levels x 8192 columns: float32 fast
   path against the float64 golden-parity path.
e  LW flux sweep: the Pallas kernel against the plain XLA sweep, alone
   and inside the radiation call.
f  Held-Suarez T42: 100 float32 steps finite; 5 steps float32 vs float64.

All programs are lowered first and compiled concurrently (XLA releases
the GIL), then run one at a time.  Every failure raises, so the exit
code is non-zero and the last line is not printed.  The last stdout line is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

import argparse
import concurrent.futures
import contextlib
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
T85 = dict(nlon=256, nlat=128, nz=28, timestep=600.0, rad_every=6,
           rad_col_chunk=8192)
N_STEPS = 12

# float32 against float64 after N_STEPS of the T85 moist GCM.  Both runs
# start from the same state; the gap is float32 rounding carried through
# the leapfrog dynamics and the physics, largest where a column's
# convection trigger flips between the two.  At T42 on the CPU the same
# comparison shows at most 0.12 K, 1.1e-4 kg/kg, 0.01 m/s, 6e-6 in ln ps,
# 0.03 W/m2 in OLR and 0.6 W/m2 in ASR.  Each limit is ten times that, or
# three times the largest gap measured at T85 on an H100 (0.12 K,
# 1.5e-4 kg/kg, 0.027 m/s, 6e-6, 0.08 and 3.3 W/m2) where that is larger.
MOIST_TOL = {'T': 1.2, 'q': 1e-3, 'u': 0.1, 'v': 0.1, 'lnps': 6e-5,
             'olr': 0.3, 'asr': 10.0}
# tests/test_radiation_fastpath.py: LW fluxes 0.5 W/m2 and heating
# 0.05 K/day, SW fluxes 1.0 W/m2 and heating 0.08 K/day, f32 fast path
# (analytic transmittance) against f64 with the Pade tables
RAD_TOL = {'lw_up': 0.5, 'lw_dn': 0.5, 'lw_hr': 0.05,
           'sw_up': 1.0, 'sw_dn': 1.0, 'sw_hr': 0.08}
# the kernel and the plain sweep evaluate the same float32 formulas; only
# the order of the g-point sum differs (tests/test_pallas_radiation.py)
SWEEP_RTOL = 2e-6
# Held-Suarez T42 after 5 steps: dry dynamics only.  On the CPU the gap
# is at most 4e-4 K, 7e-3 m/s and 5e-6 in ln ps; the limits are ten times
# that.
HS_TOL = {'T': 5e-3, 'u': 7e-2, 'v': 7e-2, 'lnps': 5e-5}


_T0 = time.perf_counter()


def say(*parts):
    print(*parts, flush=True)


def header(text):
    say('== %s  (t=%.1f s)' % (text, time.perf_counter() - _T0))


def x64():
    import jax
    return jax.enable_x64(True)


def timed(fn, *args, repeats=1):
    """Mean seconds of fn(*args) over ``repeats`` calls, and the result."""
    import jax
    t0 = time.perf_counter()
    for _ in range(repeats):
        out = fn(*args)
        jax.block_until_ready(out)
    return (time.perf_counter() - t0) / repeats, out


def compile_timed(jitted, *args):
    t0 = time.perf_counter()
    compiled = jitted.lower(*args).compile()
    return time.perf_counter() - t0, compiled


class Programs:
    """Programs of all phases: lowered in order, compiled concurrently.

    ``add(name, thunk, f64)`` lowers thunk() (a jax Lowered), under x64
    when f64; ``compile_all()`` compiles everything in threads;
    ``self[name]`` is then the compiled executable."""

    def __init__(self, card):
        self.card = card
        self.lowered, self.compiled, self.seconds = {}, {}, {}

    def add(self, name, thunk, f64=False):
        with x64() if f64 else contextlib.nullcontext():
            self.lowered[name] = thunk()

    def compile_all(self, allow_fail=False):
        """Compile concurrently; with allow_fail, a program that fails to
        compile is reported and left out instead of raising."""
        failed = {}

        def one(name):
            t0 = time.perf_counter()
            try:
                self.compiled[name] = self.lowered[name].compile()
            except Exception as err:
                if not allow_fail:
                    raise
                failed[name] = err
            self.seconds[name] = time.perf_counter() - t0
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(len(self.lowered)) as ex:
            for fut in [ex.submit(one, n) for n in self.lowered]:
                fut.result()
        for name in self.lowered:
            say('  compile %-22s %8.3f s  %s[%s]'
                % (name, self.seconds[name],
                   'FAILED: %s  ' % str(failed[name])[:300]
                   if name in failed else '', self.card))
        say('  %d programs compiled concurrently in %.3f s wall  [%s]'
            % (len(self.lowered), time.perf_counter() - t0, self.card))

    def __getitem__(self, name):
        return self.compiled[name]


def max_diff(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    err = float(np.abs(a - b).max())
    return err, err / max(float(np.abs(b).max()), 1e-30)


def compare(label, pairs, tol):
    """Print the max abs/rel gap of each pair; raise on any over tol."""
    bad = []
    for name, (a, b) in pairs.items():
        err, rel = max_diff(a, b)
        ok = err <= tol[name]
        say('  %s %-6s max abs %.3e  rel %.3e  limit %.1e  %s'
            % (label, name, err, rel, tol[name], 'ok' if ok else 'FAIL'))
        if not ok:
            bad.append(name)
    if bad:
        raise AssertionError('%s: %s over limit' % (label, ', '.join(bad)))


def to_f64(tree):
    import jax
    import jax.numpy as jnp

    def cast(x):
        if jnp.issubdtype(x.dtype, jnp.complexfloating):
            return jnp.asarray(x, jnp.complex128)
        if jnp.issubdtype(x.dtype, jnp.floating):
            return jnp.asarray(x, jnp.float64)
        return x
    with x64():
        return jax.tree_util.tree_map(cast, tree)


def memory_line(compiled):
    m = compiled.memory_analysis()
    if m is None:
        return 'memory_analysis: none'
    fields = ('argument_size_in_bytes', 'output_size_in_bytes',
              'temp_size_in_bytes', 'generated_code_size_in_bytes')
    return 'memory_analysis: ' + ', '.join(
        '%s=%d' % (f, getattr(m, f)) for f in fields if hasattr(m, f))


def peak_bytes():
    import jax
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get('peak_bytes_in_use', -1)


def check_moist_bounds(carry, diag):
    """Finite everywhere; T in [150, 350] K, q >= 0, OLR in [50, 450]."""
    import jax
    for path, leaf in jax.tree_util.tree_leaves_with_path((carry, diag)):
        arr = np.asarray(leaf)
        if arr.dtype.kind in 'fc' and not np.isfinite(arr).all():
            raise AssertionError('non-finite values in %s'
                                 % jax.tree_util.keystr(path))
    grids = carry[2]
    T = np.asarray(grids['T'])
    q = np.asarray(grids['q'])
    olr = np.asarray(diag['olr'])
    say('  T [%.2f, %.2f] K  q [%.3e, %.3e]  OLR [%.1f, %.1f] W/m2'
        % (T.min(), T.max(), q.min(), q.max(), olr.min(), olr.max()))
    assert 150.0 <= T.min() and T.max() <= 350.0, 'T out of [150, 350] K'
    assert q.min() >= 0.0, 'negative humidity'
    assert 50.0 <= olr.min() and olr.max() <= 450.0, 'OLR out of range'


def moist_fields(carry, diag):
    grids = carry[2]
    return {'T': grids['T'], 'q': grids['q'], 'u': grids['u'],
            'v': grids['v'], 'lnps': np.log(np.asarray(grids['ps'])),
            'olr': diag['olr'], 'asr': diag['asr']}


# -- (b, c) moist GCM -------------------------------------------------------

class MoistPhase:
    """(b) float32 T85 moist GCM through init_fn/run_fn; (c) the same
    steps in float64 from the same initial state."""

    def __init__(self, progs, cfg=T85, n_steps=N_STEPS):
        import jax.numpy as jnp
        from climt_tpu.dycore.moist_gcm import build_moist_gcm
        self.progs, self.cfg, self.n_steps = progs, cfg, n_steps
        _, init_fn, _, run_fn = build_moist_gcm(dtype=jnp.float32, **cfg)
        self.carry0 = init_fn()
        progs.add('moist_f32', lambda: run_fn.lower(self.carry0, n_steps))
        self.carry64 = to_f64(self.carry0)
        progs.add('moist_f64', lambda: build_moist_gcm(
            dtype=jnp.float64, **cfg)[3].lower(self.carry64, n_steps),
            f64=True)

    def run(self):
        card, cfg = self.progs.card, self.cfg
        header('b: moist GCM %dx%dx%d float32, %d steps'
               % (cfg['nlon'], cfg['nlat'], cfg['nz'], self.n_steps))
        compiled = self.progs['moist_f32']
        first_s, out = timed(compiled, self.carry0)
        second_s, _ = timed(compiled, out[0])
        say('  first call %.4f s  second call %.4f s (%.3f ms/step)  [%s]'
            % (first_s, second_s, 1e3 * second_s / self.n_steps, card))
        say('  %s  [%s]' % (memory_line(compiled), card))
        say('  peak_bytes_in_use=%d  [%s]' % (peak_bytes(), card))
        check_moist_bounds(*out)
        header('c: moist GCM float64 reference, %d steps' % self.n_steps)
        with x64():
            run_s, out64 = timed(self.progs['moist_f64'], self.carry64)
        say('  call %.4f s  [%s]' % (run_s, card))
        a, b = moist_fields(*out), moist_fields(*out64)
        compare('f32-f64', {k: (a[k], b[k]) for k in MOIST_TOL}, MOIST_TOL)


# -- (d) radiation ------------------------------------------------------------

class RadiationPhase:
    """(d) standalone radiation: float32 fast path vs float64 tables."""

    def __init__(self, progs, nz=60, ncol=8192):
        import jax.numpy as jnp
        from bench import build_radiation_bench
        self.progs, self.nz, self.ncol = progs, nz, ncol
        rad32, self.x32 = build_radiation_bench(nz, ncol)
        progs.add('rad_f32_%d' % nz, lambda: rad32.lower(self.x32))
        with x64():
            rad64, self.x64 = build_radiation_bench(
                nz, ncol, dtype=jnp.float64, use_tables=True)
        progs.add('rad_f64_%d' % nz, lambda: rad64.lower(self.x64),
                  f64=True)

    def run(self):
        card, nz = self.progs.card, self.nz
        header('d: radiation %d levels x %d columns' % (nz, self.ncol))
        c32 = self.progs['rad_f32_%d' % nz]
        c32(self.x32)
        call_s, out32 = timed(c32, self.x32, repeats=5)
        say('  float32 fast path %.6f s/call  [%s]' % (call_s, card))
        with x64():
            call_s, out64 = timed(self.progs['rad_f64_%d' % nz], self.x64)
        say('  float64 tables    %.6f s/call  [%s]' % (call_s, card))
        compare('f32-f64', {k: (out32[k], out64[k]) for k in RAD_TOL},
                RAD_TOL)


# -- (e) LW flux sweep: kernel vs plain ---------------------------------------

def sweep_inputs(nz, ncol, seed=0):
    """Random inputs of lw_spectral.rtrn_lw, Planck terms scaled so the
    fluxes come out at a few hundred W/m2."""
    import jax.numpy as jnp
    from climt_tpu.components.rrtmg.lw_spectral import NGPT
    rng = np.random.RandomState(seed)

    def arr(*shape, scale=1.0, offset=0.0):
        return jnp.asarray(offset + scale * rng.rand(*shape), jnp.float32)
    cloudy = rng.rand(nz, ncol) > 0.7
    return (arr(nz, ncol, NGPT, scale=2.0), arr(nz, ncol, NGPT),
            arr(nz, ncol, 16, scale=2e-6), arr(nz + 1, ncol, 16, scale=2e-6),
            arr(ncol, 16, scale=2e-6), arr(16, ncol, scale=0.1, offset=0.9),
            arr(ncol, scale=4.0),
            jnp.asarray(cloudy * rng.rand(nz, ncol), jnp.float32),
            arr(nz, ncol, 16, scale=3.0),
            jnp.asarray(np.linspace(1000.0, 1.0, nz + 1)[:, None]
                        * np.ones((1, ncol)), jnp.float32))


class SweepPhase:
    """(e) the Pallas sweep kernel vs the plain XLA sweep: alone on the
    same inputs, and as the sweep of the float32 radiation call."""

    NAMES = ('flux_up', 'flux_dn', 'heating', 'clear_up', 'clear_dn',
             'clear_heating')

    def __init__(self, progs, ncol=8192, levels=(60, 28)):
        import jax
        from bench import build_radiation_bench
        from climt_tpu.components.rrtmg import lw_spectral as L
        self.progs, self.ncol, self.levels = progs, ncol, levels
        heatfac = 9.80665 * 8.64e4 / (1004.64 * 1e2)
        self.args = {nz: sweep_inputs(nz, ncol) for nz in levels}
        self.rad_inputs = {}
        for nz in levels:
            for impl in ('kernel', 'plain'):
                fn = jax.jit(lambda *a, impl=impl: L.rtrn_lw(
                    *a, heatfac, use_tables=False, impl=impl))
                progs.add('sweep_%s_%d' % (impl, nz),
                          lambda fn=fn, nz=nz: fn.lower(*self.args[nz]))
                name = 'rad_f32_%d' % nz
                if impl == 'plain':
                    name += '_plain'
                if name not in progs.lowered:
                    rad, self.rad_inputs[nz] = build_radiation_bench(
                        nz, ncol, sweep=impl)
                    progs.add(name, lambda rad=rad, nz=nz:
                              rad.lower(self.rad_inputs[nz]))

    def run(self):
        card, ncol = self.progs.card, self.ncol
        header('e: LW flux sweep, Pallas kernel vs plain XLA')
        for nz in self.levels:
            res = {}
            for impl in ('kernel', 'plain'):
                compiled = self.progs['sweep_%s_%d' % (impl, nz)]
                compiled(*self.args[nz])
                call_s, res[impl] = timed(compiled, *self.args[nz],
                                          repeats=20)
                say('  sweep (%d, %d) %-6s %.6f s/call  [%s]'
                    % (nz, ncol, impl, call_s, card))
            for name, a, b in zip(self.NAMES, res['kernel'], res['plain']):
                err, rel = max_diff(a, b)
                say('  sweep (%d, %d) %-13s max abs %.3e  rel %.3e'
                    % (nz, ncol, name, err, rel))
                if not name.endswith('heating') and rel > SWEEP_RTOL:
                    raise AssertionError('kernel vs plain sweep: %s rel %.3e'
                                         % (name, rel))
            for sweep, suffix in (('kernel', ''), ('plain', '_plain')):
                compiled = self.progs['rad_f32_%d%s' % (nz, suffix)]
                x = self.rad_inputs[nz]
                compiled(x)
                call_s, _ = timed(compiled, x, repeats=5)
                say('  radiation (%d, %d) sweep=%-6s %.6f s/call  [%s]'
                    % (nz, ncol, sweep, call_s, card))


# -- (f) Held-Suarez ----------------------------------------------------------

class HeldSuarezPhase:
    """(f) Held-Suarez T42: long float32 run finite, short run vs f64."""

    def __init__(self, progs, nlon=128, nlat=64, nz=28, n_long=100,
                 n_short=5):
        import jax.numpy as jnp
        from climt_tpu.dycore.compiled import build_held_suarez_model
        self.progs = progs
        self.shape, self.n_long = (nlon, nlat, nz), n_long
        _, init_fn, _, run_fn = build_held_suarez_model(nlon, nlat, nz)
        self.carry0 = init_fn()
        self.carry64 = to_f64(self.carry0)
        progs.add('hs_f32_long', lambda: run_fn.lower(self.carry0, n_long))
        progs.add('hs_f32_short', lambda: run_fn.lower(self.carry0, n_short))
        progs.add('hs_f64_short', lambda: build_held_suarez_model(
            nlon, nlat, nz, dtype=jnp.float64)[3].lower(
                self.carry64, n_short), f64=True)

    def run(self):
        import jax
        card = self.progs.card
        header('f: Held-Suarez %dx%dx%d' % self.shape)
        call_s, out = timed(self.progs['hs_f32_long'], self.carry0)
        say('  %d steps %.4f s  [%s]' % (self.n_long, call_s, card))
        for leaf in jax.tree_util.tree_leaves(out):
            assert np.isfinite(np.asarray(leaf)).all(), 'non-finite HS state'
        short32 = self.progs['hs_f32_short'](self.carry0)
        with x64():
            short64 = self.progs['hs_f64_short'](self.carry64)
            jax.block_until_ready(short64)

        def fields(carry):
            g = carry[2]
            return {'T': g['T'], 'u': g['u'], 'v': g['v'],
                    'lnps': np.log(np.asarray(g['ps']))}
        a, b = fields(short32), fields(short64)
        compare('f32-f64', {k: (a[k], b[k]) for k in HS_TOL}, HS_TOL)


# -- (g) four devices ---------------------------------------------------------

class FourPhase:
    """(g) m-sharded moist GCM on a ('lat', 'lon') = (4, 1) mesh against
    the one-device run (layout of __graft_entry__.dryrun_multichip)."""

    def __init__(self, progs, cfg=T85, n_steps=N_STEPS):
        import jax
        import jax.numpy as jnp
        from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
        from climt_tpu.dycore.moist_gcm import build_moist_gcm
        devices = jax.devices()
        if len(devices) < 4:
            raise SystemExit('--four needs 4 devices, found %d'
                             % len(devices))
        self.progs, self.n_steps = progs, n_steps
        mesh = Mesh(np.array(devices[:4]).reshape(4, 1), ('lat', 'lon'))
        kw = dict(cfg, dtype=jnp.float32, fft_impl='matmul')
        self.ref_model = build_moist_gcm(**kw)
        self.dist_model = build_moist_gcm(mesh=mesh, **kw)
        self.ref_carry = self.ref_model[1]()
        prev, now, grids, aux, k0 = self.dist_model[1]()

        def put(tree):
            return {k: jax.device_put(v, NamedSharding(
                mesh, P(None, 'lat', None) if v.ndim == 3
                else P('lat', None))) for k, v in tree.items()}
        self.dist_carry = (put(prev), put(now), put(grids), put(aux), k0)
        progs.add('moist_1dev', lambda: self.ref_model[3].lower(
            self.ref_carry, n_steps))
        progs.add('moist_4dev', lambda: self.dist_model[3].lower(
            self.dist_carry, n_steps))

    def run(self):
        card = self.progs.card
        header('g: m-sharded moist GCM on 4 devices vs 1, %d steps'
               % self.n_steps)
        call_s, ref = timed(self.progs['moist_1dev'], self.ref_carry)
        say('  1 device  %.4f s  [%s]' % (call_s, card))
        compiled = self.progs['moist_4dev']
        call_s, out = timed(compiled, self.dist_carry)
        call2_s, _ = timed(compiled, out[0])
        say('  4 devices %.4f s  second call %.4f s  [%s]'
            % (call_s, call2_s, card))
        check_moist_bounds(*out)
        # the sharded run reorders float32 sums: a perturbation of the
        # size of float32 rounding, which grows over the steps like the
        # float32-vs-float64 gap (phase c), so it is held to those limits
        a, b = moist_fields(*out), moist_fields(*ref)
        compare('4-vs-1', {k: (a[k], b[k]) for k in MOIST_TOL}, MOIST_TOL)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--four', action='store_true',
                        help='run only the m-sharded phase on 4 devices')
    args = parser.parse_args(argv)

    from climt_tpu.utils.compile_cache import enable_compile_cache
    from climt_tpu.utils.device import card_line, require_gpu
    card = card_line()                 # before JAX touches the card
    import jax
    dev = require_gpu(jax.devices())
    header('a: device')
    say(card)
    say('  platform=%s kind=%s count=%d jax=%s XLA_FLAGS=%r'
        % (dev.platform, dev.device_kind, len(jax.devices()),
           jax.__version__, os.environ.get('XLA_FLAGS', '')))
    say('  compile cache: %s' % enable_compile_cache(REPO))

    header('lowering')
    progs = Programs(card)
    if args.four:
        phases = [FourPhase(progs)]
    else:
        phases = [MoistPhase(progs), RadiationPhase(progs),
                  SweepPhase(progs), HeldSuarezPhase(progs)]
    header('compiling')
    progs.compile_all()
    for phase in phases:
        phase.run()
    header('done')
    print(json.dumps({'ok': True, 'device': {
        'platform': dev.platform, 'kind': dev.device_kind,
        'count': len(jax.devices())}}), flush=True)


if __name__ == '__main__':
    sys.path.insert(0, REPO)
    main()
