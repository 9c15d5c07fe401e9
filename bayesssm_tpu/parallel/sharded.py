"""Particle-axis sharded filters: one engine, collective weight step.

Scale-out front-end for very large particle counts: chains shard over the
``"chains"`` mesh axis, particles over ``"particles"``, the whole filter
runs inside one ``shard_map`` — and the filter itself is the SAME
``particle_filter_core`` engine that serves the unsharded path, invoked
with ``particle_axis="particles"``. The core then completes its weight
reductions with ``pmax``/``psum`` and resamples through
``ops.resampling.sharded_resample_indices`` (shard-identical stratum
draws + one ``all_gather``), so:

  * the marginal-likelihood increment is exactly the single-device
    ``max + log(sum exp(lw - max)) - log(N)`` telescoping term
    (unbiasedness preserved under sharding, BASELINE.md config 2);
  * every core feature — obs_times gaps, masked traced particle counts,
    APF's double-transition lookahead (quirk Q2), RMPF rejuvenation,
    carry_weights — holds under sharding with no second implementation
    to drift.

The reference has no analogue — its resampling is a serial C++ loop over a
single process's vector (/root/reference/src/resampling.cpp); this is the
"distributed systematic resampling" component called out in SURVEY.md §7
step 7.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from bayesssm_tpu.filters.core import particle_filter_core

__all__ = ["sharded_particle_filter", "sharded_bootstrap_filter"]


def sharded_particle_filter(
    root_key,
    y,
    num_particles: int,
    init_fn,
    transition_fn,
    log_likelihood_fn,
    theta: dict,
    num_chains: int,
    mesh: Mesh,
    algorithm: str = "BPF",
    aux_log_likelihood_fn=None,
    move_fn=None,
    obs_times=None,
    resample_algorithm: str = "SISAR",
    resample_fn: str = "systematic",
    threshold: float | None = None,
    carry_weights: bool = False,
):
    """Run a chains+particles-sharded filter; returns (loglike [C], state_est).

    Args:
      root_key: single PRNG key; chain streams derive from
        fold_in(root_key, global_chain_id) so results are independent of
        device placement.
      theta: dict of [num_chains] parameter arrays.
      num_chains / num_particles: GLOBAL counts; must be divisible by the
        respective mesh axis sizes.
      algorithm / aux_log_likelihood_fn / move_fn / obs_times /
      resample_* / carry_weights: forwarded to ``particle_filter_core``
        (same contracts as the unsharded front-ends).

    Returns:
      ``(loglike [num_chains], state_est [num_chains, T, d])`` — state
      estimates exclude the t=0 entry, matching the observation grid.
    """
    if resample_algorithm not in ("SIS", "SISR", "SISAR"):
        raise ValueError("resample_algorithm must be SIS, SISR or SISAR")
    from bayesssm_tpu.ops.resampling import RESAMPLE_METHODS

    if resample_fn not in RESAMPLE_METHODS:
        raise ValueError("unknown resample_fn")

    cs = mesh.shape["chains"]
    ps = mesh.shape["particles"]
    if num_chains % cs or num_particles % ps:
        raise ValueError(
            "num_chains/num_particles must divide the mesh axis sizes"
        )
    c_local = num_chains // cs

    ys = jnp.asarray(y)
    theta_stack = {k: jnp.asarray(v) for k, v in theta.items()}

    def shard_fn(ys_in, theta_local):
        c_idx = lax.axis_index("chains")
        chain_ids = c_idx * c_local + jnp.arange(c_local)
        chain_keys = jax.vmap(lambda i: jax.random.fold_in(root_key, i))(
            chain_ids
        )

        def one_chain(ck, th):
            res = particle_filter_core(
                ck,
                ys_in,
                num_particles,
                init_fn,
                transition_fn,
                log_likelihood_fn,
                aux_weight_fn=aux_log_likelihood_fn,
                move_fn=move_fn,
                theta=th,
                obs_times=obs_times,
                algorithm=algorithm,
                resample_algorithm=(
                    "SISR" if algorithm == "RMPF" else resample_algorithm
                ),
                resample_fn=resample_fn,
                threshold=threshold,
                return_particles=False,
                carry_weights=carry_weights,
                particle_axis="particles",
                particle_axis_size=ps,
            )
            state = res.state_est[1:]            # drop the t=0 entry
            if state.ndim == 1:
                state = state[:, None]
            return res.loglike, state

        return jax.vmap(one_chain)(chain_keys, theta_local)

    fn = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(None, None) if ys.ndim == 2 else P(None), P("chains")),
        out_specs=(P("chains"), P("chains")),
        check_vma=False,
    )
    return fn(ys, theta_stack)


def sharded_bootstrap_filter(
    root_key,
    y,
    num_particles: int,
    init_fn,
    transition_fn,
    log_likelihood_fn,
    theta: dict,
    num_chains: int,
    mesh: Mesh,
    resample_algorithm: str = "SISAR",
    resample_fn: str = "systematic",
    threshold: float | None = None,
):
    """Chains+particles-sharded BPF (see ``sharded_particle_filter``)."""
    return sharded_particle_filter(
        root_key, y, num_particles, init_fn, transition_fn,
        log_likelihood_fn, theta, num_chains, mesh,
        algorithm="BPF", resample_algorithm=resample_algorithm,
        resample_fn=resample_fn, threshold=threshold,
    )
