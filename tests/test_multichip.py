"""Multi-device correctness: sharded execution must give the same answer
as single-device execution.

The reference has no distributed tests (SURVEY.md §4.7: "no distributed
tests, no multi-node harness"); this suite is the multi-device addition the
survey prescribes — sharded-vs-unsharded equivalence on a forced 8-device
CPU mesh (tests/conftest.py sets --xla_force_host_platform_device_count=8).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from climt_tpu.parallel.mesh import make_mesh, shard_model_state


def _tree_allclose(a, b, rtol, atol, path=''):
    assert type(a) is type(b), (path, type(a), type(b))
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _tree_allclose(a[k], b[k], rtol, atol, path + '/' + str(k))
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _tree_allclose(x, y, rtol, atol, path + '/' + str(i))
    else:
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=rtol, atol=atol,
            err_msg=path)


def _run_n(step_fn, n_steps):
    def run(carry):
        for _ in range(n_steps):
            carry, _ = step_fn(carry, None)
        return carry
    return run


@pytest.mark.skipif(len(jax.devices()) < 8, reason='needs 8 devices')
def test_moist_gcm_sharded_matches_single_device():
    """N fused moist-GCM steps with the production sharding layout must
    match the unsharded run (collectives change reduction order only at
    roundoff; x64 keeps that far below tolerance)."""
    from climt_tpu.dycore.moist_gcm import build_moist_gcm

    # matmul-DFT zonal transform: layout-robust under partitioning
    dycore, init_fn, step_fn, run_fn = build_moist_gcm(
        nlon=32, nlat=16, nz=8, timestep=600.0, dtype=jnp.float64,
        fft_impl='matmul')

    run = _run_n(step_fn, 3)

    carry0 = init_fn()
    ref = jax.jit(run)(carry0)
    ref = jax.tree_util.tree_map(np.asarray, ref)

    mesh = make_mesh(8)
    carry_sharded = shard_model_state(mesh, *init_fn())
    with mesh:
        out = jax.jit(run)(carry_sharded)
        out = jax.tree_util.tree_map(np.asarray, out)

    _tree_allclose(out, ref, rtol=1e-9, atol=1e-12)


@pytest.mark.skipif(len(jax.devices()) < 8, reason='needs 8 devices')
def test_lon_sharded_matches_single_device():
    """2-D (lat, lon) decomposition — longitude sharded too — must also
    reproduce the single-device answer."""
    from climt_tpu.dycore.moist_gcm import build_moist_gcm

    dycore, init_fn, step_fn, run_fn = build_moist_gcm(
        nlon=32, nlat=16, nz=8, timestep=600.0, dtype=jnp.float64,
        fft_impl='matmul')

    run = _run_n(step_fn, 1)
    ref = jax.tree_util.tree_map(np.asarray, jax.jit(run)(init_fn()))

    mesh = make_mesh(8, mesh_shape=(4, 2))
    carry_sharded = shard_model_state(mesh, *init_fn(), shard_lon=True)
    with mesh:
        out = jax.tree_util.tree_map(
            np.asarray, jax.jit(run)(carry_sharded))

    _tree_allclose(out, ref, rtol=1e-9, atol=1e-12)


@pytest.mark.skipif(len(jax.devices()) < 8, reason='needs 8 devices')
def test_m_sharded_spectral_matches_single_device():
    """The PRODUCTION multi-chip layout — spectral state m-sharded via
    DistributedSHT (all_to_all transposes inside the fused step) — must
    reproduce the replicated-spectral single-device run at f64.

    This is the layout dryrun_multichip exercises and the one the model
    needs at T170+, where replicating spectral coefficients stops
    scaling (VERDICT r3 item 3)."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from climt_tpu.dycore.moist_gcm import build_moist_gcm

    nlon, nlat, nz = 32, 16, 8
    ref_model = build_moist_gcm(
        nlon=nlon, nlat=nlat, nz=nz, timestep=600.0, dtype=jnp.float64,
        fft_impl='matmul')

    mesh = Mesh(np.array(jax.devices()[:8]).reshape(8, 1), ('lat', 'lon'))
    dist_model = build_moist_gcm(
        nlon=nlon, nlat=nlat, nz=nz, timestep=600.0, dtype=jnp.float64,
        fft_impl='matmul', mesh=mesh)

    run = _run_n(ref_model[2], 3)
    ref = jax.jit(run)(ref_model[1]())

    spec3 = NamedSharding(mesh, P(None, 'lat', None))
    spec2 = NamedSharding(mesh, P('lat', None))
    grid3 = NamedSharding(mesh, P(None, 'lat', None))
    grid2 = NamedSharding(mesh, P('lat', None))
    prev, now, grids, aux, k0 = dist_model[1]()
    prev = {k: jax.device_put(v, spec3 if v.ndim == 3 else spec2)
            for k, v in prev.items()}
    now = {k: jax.device_put(v, spec3 if v.ndim == 3 else spec2)
           for k, v in now.items()}
    grids = {k: jax.device_put(v, grid3 if v.ndim == 3 else grid2)
             for k, v in grids.items()}
    aux = {k: jax.device_put(v, grid3 if v.ndim == 3 else grid2)
           for k, v in aux.items()}

    run_d = _run_n(dist_model[2], 3)
    out = jax.jit(run_d)((prev, now, grids, aux, k0))

    # spectral shapes differ (m-padding): compare in grid space
    for name in ('vort', 'div', 'T', 'q', 'lnps'):
        for slot in (0, 1):
            a = np.asarray(ref_model[0].sht.synthesize(ref[slot][name]))
            b = np.asarray(dist_model[0].sht.synthesize(out[slot][name]))
            np.testing.assert_allclose(b, a, rtol=1e-8, atol=1e-10,
                                       err_msg=name)
    _tree_allclose(jax.tree_util.tree_map(np.asarray, out[3]),
                   jax.tree_util.tree_map(np.asarray, ref[3]),
                   rtol=1e-8, atol=1e-10)


@pytest.mark.skipif(len(jax.devices()) < 8, reason='needs 8 devices')
def test_m_sharded_fv_moisture_matches_single_device():
    """m-sharded spectral dynamics + FV grid-space moisture with
    ppermute halo exchange must match the single-device FV run."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from climt_tpu.dycore.moist_gcm import build_moist_gcm

    nlon, nlat, nz = 32, 16, 8
    ref_model = build_moist_gcm(
        nlon=nlon, nlat=nlat, nz=nz, timestep=600.0, dtype=jnp.float64,
        fft_impl='matmul', moisture_advection='fv')

    mesh = Mesh(np.array(jax.devices()[:8]).reshape(8, 1), ('lat', 'lon'))
    dist_model = build_moist_gcm(
        nlon=nlon, nlat=nlat, nz=nz, timestep=600.0, dtype=jnp.float64,
        fft_impl='matmul', mesh=mesh, moisture_advection='fv')

    run = _run_n(ref_model[2], 2)
    ref = jax.jit(run)(ref_model[1]())

    spec3 = NamedSharding(mesh, P(None, 'lat', None))
    spec2 = NamedSharding(mesh, P('lat', None))
    grid3 = NamedSharding(mesh, P(None, 'lat', None))
    grid2 = NamedSharding(mesh, P('lat', None))

    def put_state(tree):
        # fv mode: 'q' is a real grid array; others complex spectral —
        # both are (·, m-or-lat, ·) rank-3 or rank-2, same specs apply
        return {k: jax.device_put(v, spec3 if v.ndim == 3 else spec2)
                for k, v in tree.items()}

    prev, now, grids, aux, k0 = dist_model[1]()
    prev, now = put_state(prev), put_state(now)
    grids = {k: jax.device_put(v, grid3 if v.ndim == 3 else grid2)
             for k, v in grids.items()}
    aux = {k: jax.device_put(v, grid3 if v.ndim == 3 else grid2)
           for k, v in aux.items()}

    out = jax.jit(_run_n(dist_model[2], 2))((prev, now, grids, aux, k0))

    for name in ('vort', 'div', 'T', 'lnps'):
        for slot in (0, 1):
            a = np.asarray(ref_model[0].sht.synthesize(ref[slot][name]))
            b = np.asarray(
                dist_model[0].sht.synthesize(out[slot][name]))
            np.testing.assert_allclose(b, a, rtol=1e-8, atol=1e-10,
                                       err_msg=name)
    for slot in (0, 1):
        np.testing.assert_allclose(
            np.asarray(out[slot]['q']), np.asarray(ref[slot]['q']),
            rtol=1e-8, atol=1e-12, err_msg='q (fv grid)')
