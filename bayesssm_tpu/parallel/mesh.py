"""Device-mesh helpers for chain-parallel PMMH.

The reference's only parallelism is one OS process per MCMC chain
(/root/reference/R/pmmh.R:512-531, `future_lapply`). The SPMD
equivalent: chains are the leading axis of every per-chain array, and that
axis is sharded over a ``jax.sharding.Mesh`` axis named ``"chains"`` —
no communication during sampling, collectives only at the diagnostics
boundary (SURVEY.md §5). A second mesh axis ``"particles"`` is reserved for
sharding the particle dimension of very large filters.
"""

from __future__ import annotations

import dataclasses

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = [
    "MeshConfig",
    "make_chain_mesh",
    "shard_chain_tree",
    "chain_sharding",
]


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Typed mesh configuration (SURVEY.md §5 config row).

    Captures the device-layout choices for a PMMH run — the SPMD
    analogue of the reference's single ``num_cores`` argument
    (/root/reference/R/pmmh.R:253) generalized to a 2-D
    ``(chains, particles)`` mesh. ``build()`` materializes the
    ``jax.sharding.Mesh``; pass that to ``pmmh(mesh=...)``.
    """

    n_devices: int | None = None
    particle_axis_size: int = 1
    chain_axis: str = "chains"
    particle_axis: str = "particles"

    def __post_init__(self):
        if self.particle_axis_size < 1:
            raise ValueError("particle_axis_size must be >= 1")
        if self.n_devices is not None and self.n_devices < 1:
            raise ValueError("n_devices must be >= 1")
        if self.chain_axis == self.particle_axis:
            raise ValueError("chain_axis and particle_axis must differ")

    def build(self, devices=None) -> Mesh:
        """Create the ``(chain_axis, particle_axis)`` mesh."""
        if devices is None:
            devices = jax.devices()
        n = self.n_devices if self.n_devices is not None else len(devices)
        arr = np.asarray(devices[:n])
        if n % self.particle_axis_size:
            raise ValueError(
                "n_devices must be divisible by particle_axis_size"
            )
        shape = (n // self.particle_axis_size, self.particle_axis_size)
        return Mesh(arr.reshape(shape), (self.chain_axis, self.particle_axis))


def make_chain_mesh(
    n_devices: int | None = None,
    particle_axis_size: int = 1,
    devices=None,
) -> Mesh:
    """Create a ``("chains", "particles")`` mesh.

    By default all local devices go on the chains axis (the embarrassingly
    parallel direction); ``particle_axis_size`` > 1 carves devices off for
    particle-axis sharding.
    """
    if devices is None:
        devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    devices = np.asarray(devices[:n_devices])
    if n_devices % particle_axis_size != 0:
        raise ValueError("n_devices must be divisible by particle_axis_size")
    shape = (n_devices // particle_axis_size, particle_axis_size)
    return Mesh(devices.reshape(shape), ("chains", "particles"))


def chain_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding that splits axis 0 (chains) across the chains mesh axis."""
    return NamedSharding(mesh, P("chains"))


def shard_chain_tree(tree, mesh: Mesh):
    """Device-put every array in a pytree with its axis 0 sharded on chains."""
    sh = chain_sharding(mesh)
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, sh), tree)
