"""Pilot-run tuning for PMMH.

Re-implements /root/reference/R/pmmh_tuning.R as jitted JAX programs:

  * ``run_pilot_chain`` — a non-adaptive random-walk Metropolis pilot chain
    of length ``pilot_m`` with per-parameter proposal SDs (:111-317). The
    reference's "re-propose until the prior is finite" while-loop (Q7,
    :192-208) becomes a bounded ``lax.while_loop``. Posterior mean and
    covariance are computed on the UNTRANSFORMED second half of the chain
    (Q6, :260-267).
  * ``pilot_run`` — ``pilot_reps`` particle-filter evaluations at the pilot
    posterior mean, vectorized with ``vmap`` instead of the reference's
    serial loop (:29-64); ``target_n = clamp(ceil(pilot_n * var), 50, 1000)``
    (Q10, :54-57).

Everything is single-chain and pure; the driver vmaps it across chains so
each chain gets its own tuned particle count and proposal covariance
(reference Q9).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
from jax import lax

from bayesssm_tpu.filters.core import particle_filter_core
from bayesssm_tpu.pmmh.priors import sum_log_priors
from bayesssm_tpu.pmmh.transforms import (
    back_transform_params,
    log_jacobian,
    transform_params,
)

__all__ = ["TuneControl", "default_tune_control", "run_pilot_chain", "pilot_run"]

_RESAMPLE_ALGOS = ("SISAR", "SISR", "SIS")
_RESAMPLE_FNS = ("stratified", "systematic", "multinomial")

# Cap on the reference's unbounded re-propose-until-valid loop (Q7).
MAX_PROPOSAL_TRIES = 100

TARGET_N_MIN = 50
TARGET_N_MAX = 1000


@dataclasses.dataclass(frozen=True)
class TuneControl:
    """Validated pilot tuning configuration.

    Mirrors default_tune_control (/root/reference/R/pmmh.R:33-58).
    ``pilot_target_var`` and ``pilot_burn_in`` exist in the reference config
    but are never read by its tuning code (Q10; the pilot chain always
    discards its first half) — kept for config parity.
    """

    pilot_proposal_sd: float = 0.5
    pilot_n: int = 100
    pilot_m: int = 2000
    pilot_target_var: float = 1.0
    pilot_burn_in: int = 500
    pilot_reps: int = 100
    pilot_resample_algorithm: str = "SISAR"
    pilot_resample_fn: str = "stratified"


def default_tune_control(
    pilot_proposal_sd: float = 0.5,
    pilot_n: int = 100,
    pilot_m: int = 2000,
    pilot_target_var: float = 1.0,
    pilot_burn_in: int = 500,
    pilot_reps: int = 100,
    pilot_resample_algorithm: str = "SISAR",
    pilot_resample_fn: str = "stratified",
) -> TuneControl:
    """Create validated tuning controls (R/pmmh.R:33-58)."""
    if not (pilot_proposal_sd >= 0 and jnp.isfinite(pilot_proposal_sd)):
        raise ValueError("pilot_proposal_sd must be a finite non-negative number")
    for name, val in [
        ("pilot_n", pilot_n),
        ("pilot_m", pilot_m),
        ("pilot_burn_in", pilot_burn_in),
        ("pilot_reps", pilot_reps),
    ]:
        if not isinstance(val, int) or val < 1:
            raise ValueError(f"{name} must be a positive integer")
    if not (pilot_target_var >= 0):
        raise ValueError("pilot_target_var must be non-negative")
    if pilot_resample_algorithm not in _RESAMPLE_ALGOS:
        raise ValueError(f"pilot_resample_algorithm must be one of {_RESAMPLE_ALGOS}")
    if pilot_resample_fn not in _RESAMPLE_FNS:
        raise ValueError(f"pilot_resample_fn must be one of {_RESAMPLE_FNS}")
    return TuneControl(
        pilot_proposal_sd=float(pilot_proposal_sd),
        pilot_n=int(pilot_n),
        pilot_m=int(pilot_m),
        pilot_target_var=float(pilot_target_var),
        pilot_burn_in=int(pilot_burn_in),
        pilot_reps=int(pilot_reps),
        pilot_resample_algorithm=pilot_resample_algorithm,
        pilot_resample_fn=pilot_resample_fn,
    )


def _particle_lane_bound(max_n: int) -> int:
    """Static particle-lane bound: the next power of two >= ``max_n``.

    The whole-sweep kernel (ops/sweep_builder.py) spans its particles
    with one Triton block, and Triton block shapes are powers of two.
    Masked lanes keep each chain at its own tuned target_n (Q9), so the
    padding is statistically invisible; the plain engine pays for the
    masked lanes (at most 2x the tuned count).
    """
    bound = 1
    while bound < max_n:
        bound *= 2
    return bound


def _make_pf_loglike(
    y,
    num_particles,
    param_names,
    model_fns,
    obs_times,
    algorithm,
    resample_algorithm,
    resample_fn,
    carry_weights,
    max_particles=None,
    particle_axis=None,
    particle_axis_size=1,
):
    """Build key, theta_vec -> (loglike, state_est) for a fixed PF config.

    ``particle_axis``/``particle_axis_size`` route the filter through the
    collective particle-sharded core path (the caller must run the result
    inside a ``shard_map`` over that mesh axis; see pmmh's mesh handling).
    """
    init_fn, transition_fn, log_likelihood_fn, aux_fn, move_fn = model_fns

    def pf(key, theta_vec, n=num_particles):
        theta = {name: theta_vec[j] for j, name in enumerate(param_names)}
        res = particle_filter_core(
            key=key,
            y=y,
            num_particles=n,
            init_fn=init_fn,
            transition_fn=transition_fn,
            weight_fn=log_likelihood_fn,
            aux_weight_fn=aux_fn,
            move_fn=move_fn,
            theta=theta,
            obs_times=obs_times,
            algorithm=algorithm,
            resample_algorithm=resample_algorithm,
            resample_fn=resample_fn,
            return_particles=False,
            max_particles=max_particles,
            carry_weights=carry_weights,
            particle_axis=particle_axis,
            particle_axis_size=particle_axis_size,
        )
        return res.loglike, res.state_est

    return pf


def _propose_until_valid(key, z, proposal_sd, transforms, prior_fns, theta_curr):
    """Bounded analogue of the reference's re-propose loop (Q7, :192-208).

    Draws z' = z + sd * eps until the back-transformed proposal has a finite
    prior, up to MAX_PROPOSAL_TRIES; falls back to the current (always
    valid) theta if the cap is hit.
    """
    p = z.shape[0]

    def cond(state):
        _, _, valid, tries = state
        return jnp.logical_and(~valid, tries < MAX_PROPOSAL_TRIES)

    def body(state):
        key, _, _, tries = state
        key, k = jax.random.split(key)
        zp = z + proposal_sd * jax.random.normal(k, (p,), dtype=z.dtype)
        thp = back_transform_params(zp, transforms)
        valid = jnp.isfinite(sum_log_priors(thp, prior_fns))
        return key, thp, valid, tries + 1

    init = (key, theta_curr, jnp.asarray(False), jnp.asarray(0))
    _, theta_prop, valid, _ = lax.while_loop(cond, body, init)
    return jnp.where(valid, theta_prop, theta_curr)


def run_pilot_chain(
    key,
    y,
    param_names,
    model_fns,
    prior_fns,
    init_theta,
    transforms,
    control: TuneControl,
    obs_times=None,
    algorithm: str = "BPF",
    jacobian_convention: str = "consistent",
    carry_weights: bool = False,
    pf_impl=None,
):
    """Run one pilot RWM chain + pilot variance run; returns a dict.

    Single-chain and fully traced — the driver wraps it in jit(vmap(...)).
    Returns pilot_theta_mean [P], pilot_theta_cov [P, P] (untransformed
    scale, Q6), target_n (traced scalar), pilot_theta_chain [pilot_m, P],
    pilot_loglike_chain [pilot_m], and variance_estimate.

    ``pf_impl`` optionally replaces ``_make_pf_loglike`` (same signature)
    with a custom filter evaluator — e.g. a whole-sweep Pallas kernel.
    """
    p = len(param_names)
    init_theta = jnp.asarray(init_theta)
    proposal_sd = jnp.broadcast_to(
        jnp.asarray(control.pilot_proposal_sd, dtype=init_theta.dtype), (p,)
    )
    # Pad the pilot filter's lane count to a power of two (masked lanes
    # keep the effective particle count at exactly pilot_n) so the pilot
    # chain also runs on a whole-sweep pf_impl.
    pf = (pf_impl or _make_pf_loglike)(
        y,
        control.pilot_n,
        param_names,
        model_fns,
        obs_times,
        algorithm,
        control.pilot_resample_algorithm,
        control.pilot_resample_fn,
        carry_weights,
        max_particles=_particle_lane_bound(control.pilot_n),
    )

    key, k0 = jax.random.split(key)
    ll0, _ = pf(k0, init_theta)

    def step(carry, _):
        key, theta, ll = carry
        key, k_prop, k_pf, k_acc = jax.random.split(key, 4)
        z = transform_params(theta, transforms)
        theta_prop = _propose_until_valid(
            k_prop, z, proposal_sd, transforms, prior_fns, theta
        )
        ll_prop, _ = pf(k_pf, theta_prop)
        log_ratio = (
            sum_log_priors(theta_prop, prior_fns)
            + ll_prop
            + log_jacobian(theta_prop, transforms, jacobian_convention)
        ) - (
            sum_log_priors(theta, prior_fns)
            + ll
            + log_jacobian(theta, transforms, jacobian_convention)
        )
        log_ratio = jnp.where(jnp.isnan(log_ratio), -jnp.inf, log_ratio)
        accept = jnp.log(jax.random.uniform(k_acc)) < log_ratio
        theta = jnp.where(accept, theta_prop, theta)
        ll = jnp.where(accept, ll_prop, ll)
        return (key, theta, ll), (theta, ll, accept)

    (key, _, _), (thetas, lls, accepts) = lax.scan(
        step, (key, init_theta, ll0), None, length=control.pilot_m - 1
    )
    theta_chain = jnp.concatenate([init_theta[None], thetas], axis=0)
    loglike_chain = jnp.concatenate([ll0[None], lls], axis=0)

    # Posterior summaries on the untransformed second half (Q6, :260-267).
    burn = control.pilot_m // 2
    post = theta_chain[burn:]
    theta_mean = jnp.mean(post, axis=0)
    centered = post - theta_mean
    theta_cov = centered.T @ centered / (post.shape[0] - 1)

    target_n, var_est = pilot_run(key, theta_mean, pf, control)

    return {
        "pilot_theta_mean": theta_mean,
        "pilot_theta_cov": theta_cov,
        "target_n": target_n,
        "variance_estimate": var_est,
        "pilot_theta_chain": theta_chain,
        "pilot_loglike_chain": loglike_chain,
        "pilot_accept_rate": jnp.mean(accepts.astype(jnp.float32)),
    }


def pilot_run(key, theta_mean, pf, control: TuneControl):
    """Estimate Var(loglike) at theta_mean and derive target_n (:29-64)."""
    keys = jax.random.split(key, control.pilot_reps)
    lls = jax.vmap(lambda k: pf(k, theta_mean)[0])(keys)
    var_est = jnp.var(lls, ddof=1)
    # -inf loglikes give inf/NaN variance -> clamp to the max particle count.
    var_safe = jnp.where(jnp.isnan(var_est), jnp.inf, var_est)
    target = jnp.ceil(control.pilot_n * var_safe)
    target = jnp.clip(target, TARGET_N_MIN, TARGET_N_MAX)
    return target, var_est
