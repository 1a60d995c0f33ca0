"""Import-first helper: force JAX onto host CPU with float64 enabled.

Usage (must be the FIRST import in an analysis script):

    import sys; sys.path.insert(0, 'tools'); import cpu_env  # noqa

Mirrors tests/conftest.py: pins JAX to the CPU, so ad-hoc analysis runs
never claim a GPU, and enables x64 so golden comparisons against the
reference's double-precision caches are meaningful.
"""

import os

os.environ['JAX_PLATFORMS'] = 'cpu'
os.environ['XLA_FLAGS'] = (
    os.environ.get('XLA_FLAGS', '') +
    ' --xla_force_host_platform_device_count=8').strip()

import jax  # noqa: E402

jax.config.update('jax_platforms', 'cpu')
jax.config.update('jax_enable_x64', True)
