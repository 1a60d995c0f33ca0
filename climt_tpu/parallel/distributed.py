"""Multi-host initialization (jax.distributed) and mesh construction.

The reference has no distributed computing at all ("climt does not yet
support MPI", /root/reference/docs/configuration.rst:41); this is the
multi-host layer: one JAX process per GPU host, XLA collectives through
NCCL over NVLink within a host and the network across hosts (no custom
transport).

Typical multi-host entry:

    from climt_tpu.parallel import initialize_distributed, make_mesh
    initialize_distributed('host0:1234', num_processes=2, process_id=rank)
    mesh = make_mesh()                  # spans jax.devices() (all hosts)

after which the fused moist-GCM step runs under the mesh exactly as in
tests/test_multichip.py — grid fields sharded over (lat, lon), spectral
state replicated (small grids) or m-sharded via DistributedSHT (large).
"""

from __future__ import annotations

import logging

logger = logging.getLogger(__name__)

_initialized = False


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None, local_device_ids=None):
    """Initialize jax.distributed for a multi-host run (idempotent).

    Pass the coordinator address (``host:port``, reachable from every
    host), the world size and this process's rank; any failure then
    raises.  With no arguments JAX tries to detect a cluster from its
    environment (e.g. SLURM); when it finds none the run continues
    single-process and a warning is logged.
    """
    global _initialized
    import jax

    if _initialized:
        return jax.process_count()
    kwargs = {}
    if coordinator_address is not None:
        kwargs.update(coordinator_address=coordinator_address,
                      num_processes=num_processes,
                      process_id=process_id)
    if local_device_ids is not None:
        kwargs.update(local_device_ids=local_device_ids)
    try:
        jax.distributed.initialize(**kwargs)
    except Exception as err:
        if coordinator_address is not None:
            raise
        logger.warning(
            'jax.distributed.initialize found no cluster (%s); running '
            'single-process', err)
        return jax.process_count()
    _initialized = True
    return jax.process_count()


def process_info():
    """(process_id, process_count, local_devices, global_devices)."""
    import jax
    return (jax.process_index(), jax.process_count(),
            jax.local_device_count(), jax.device_count())
