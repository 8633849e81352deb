"""Multi-process initialization.

The reference is single-process (SURVEY.md §2 parallelism inventory).
Call init_distributed() once per process before building meshes; every
jax.devices() call then sees the global device set and the
("data", "index") mesh in dist/mesh.py spans processes and hosts.
"""

from __future__ import annotations

import logging
import os
from typing import List, Optional

log = logging.getLogger(__name__)

_LOCAL_HOSTS = ("localhost", "127.0.0.1", "::1", "[::1]")


def local_device_ids_for(
    coordinator_address: Optional[str], process_id: Optional[int]
) -> Optional[List[int]]:
    """Which local devices this process opens.

    A coordinator on the loopback address means every process of the
    job runs on this host, so process i opens local device i only: two
    processes never reserve the same card.  Otherwise None (JAX's own
    default: every local device, or one per process under Slurm/MPI).
    """
    if coordinator_address is None or process_id is None:
        return None
    host = coordinator_address.rsplit(":", 1)[0]
    return [process_id] if host in _LOCAL_HOSTS else None


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Initialize jax.distributed when running multi-process.

    No-ops (returns False) when single-process: explicit args absent and
    no cluster env (JAX autodetects Slurm and similar launchers).  Safe
    to call unconditionally from CLIs.  A failed initialization raises:
    carrying on single-process would silently quantify only this
    process's share of the reads.
    """
    import jax

    explicit = coordinator_address is not None
    cluster_env = any(
        os.environ.get(v) for v in ("COORDINATOR_ADDRESS", "SLURM_JOB_ID")
    )
    if not explicit and not cluster_env:
        return False
    # Cross-process collectives on the CPU backend need gloo (the
    # default "none" fails at the first psum); unused on other backends.
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids_for(coordinator_address, process_id),
    )
    log.info(
        "jax.distributed initialized: process %d/%d",
        jax.process_index(),
        jax.process_count(),
    )
    return True
