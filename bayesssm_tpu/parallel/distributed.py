"""Multi-host initialization helpers.

The reference is strictly single-machine (SURVEY.md §2); this module is the
entry point for running PMMH across several hosts: call
``initialize()`` once per host process, then build the global mesh with
``global_chain_mesh()`` — chains shard across hosts and across the
cards of each host, with no communication in the sampling hot loop and
collectives only at the diagnostics boundary (exactly the reference's
process model, lifted to SPMD).

Not exercised by the single-process tests; the sharding logic it
feeds (parallel/mesh.py, parallel/sharded.py) is validated on the virtual
8-device CPU mesh instead.
"""

from __future__ import annotations

import numpy as np

import jax

__all__ = ["initialize", "global_chain_mesh"]


def initialize(coordinator_address=None, num_processes=None, process_id=None):
    """Initialize jax.distributed for a multi-host run (no-op if single)."""
    if num_processes in (None, 1):
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_chain_mesh(particle_axis_size: int = 1):
    """A ("chains", "particles") mesh over ALL processes' devices."""
    from jax.sharding import Mesh

    devices = np.asarray(jax.devices())
    n = devices.size
    if n % particle_axis_size:
        raise ValueError("device count must divide particle_axis_size")
    return Mesh(
        devices.reshape(n // particle_axis_size, particle_axis_size),
        ("chains", "particles"),
    )
