"""Distributed (particle-sharded) filter tests on the 8-device CPU mesh.

Key contract (BASELINE.md): the log-marginal-likelihood estimator stays
exactly the reference's telescoping product under sharded resampling —
verified against the Kalman truth — and the filter is placement-independent
(same root key => same per-chain results for any chains x particles mesh
split).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bayesssm_tpu.models.lgss import lgss_model, simulate_lgss
from bayesssm_tpu.parallel.mesh import make_chain_mesh
from bayesssm_tpu.parallel.sharded import sharded_bootstrap_filter
from bayesssm_tpu.utils.kalman import kalman_loglik

(MODEL_FNS, _, _) = lgss_model()
INIT_FN, TRANSITION_FN, LOGLIK_FN = MODEL_FNS
A, C, SX, SY = 0.9, 1.0, 0.6, 0.4
_, Y = simulate_lgss(1405, t_val=20, a=A, sigma_x=SX, sigma_y=SY)

THETA8 = {
    "a": jnp.full((8,), A),
    "sigma_x": jnp.full((8,), SX),
    "sigma_y": jnp.full((8,), SY),
}


def theta_for(num_chains):
    return {"a": jnp.full((num_chains,), A),
            "sigma_x": jnp.full((num_chains,), SX),
            "sigma_y": jnp.full((num_chains,), SY)}


def run(mesh, key=0, num_chains=8, num_particles=256, **kw):
    # Chains are independent replicate estimators: statistical tests below
    # raise num_chains instead of looping root keys, so each configuration
    # traces/compiles exactly ONE shard_map program (suite wall-time).
    return sharded_bootstrap_filter(
        jax.random.key(key), Y, num_particles, INIT_FN, TRANSITION_FN,
        LOGLIK_FN, theta_for(num_chains), num_chains=num_chains, mesh=mesh,
        **kw,
    )


def test_runs_and_shapes():
    mesh = make_chain_mesh(8, particle_axis_size=4)
    ll, states = run(mesh)
    assert ll.shape == (8,)
    assert states.shape == (8, len(Y), 1)
    assert np.isfinite(np.asarray(ll)).all()


def test_unbiased_vs_kalman_under_sharding():
    # SISR (always resample): unbiased estimator; mean over 48 independent
    # chains must hit the exact Kalman log-likelihood.
    truth = kalman_loglik(Y, A, C, SX, SY)
    mesh = make_chain_mesh(8, particle_axis_size=4)
    ll, _ = run(mesh, num_chains=48, num_particles=1024,
                resample_algorithm="SISR")
    lls = np.asarray(ll, dtype=np.float64)
    assert abs(lls.mean() - truth) < 0.2
    assert lls.std() < 1.0


def test_placement_independent_rng():
    # Same root key, different particle-axis splits: identical results up
    # to float reduction tolerance (RNG streams derive from chain ids and
    # shard ids, which are layout-stable for fixed ps; across ps the
    # estimator distribution must agree).
    m1 = make_chain_mesh(8, particle_axis_size=1)
    m2 = make_chain_mesh(8, particle_axis_size=2)
    m4 = make_chain_mesh(8, particle_axis_size=4)
    ll1, _ = run(m1, key=3, resample_algorithm="SISR")
    ll2, _ = run(m2, key=3, resample_algorithm="SISR")
    ll4, _ = run(m4, key=3, resample_algorithm="SISR")
    for ll in (np.asarray(ll1), np.asarray(ll2), np.asarray(ll4)):
        assert np.isfinite(ll).all()
    # Distributional agreement across layouts.
    assert abs(np.mean(np.asarray(ll1)) - np.mean(np.asarray(ll4))) < 1.0


@pytest.mark.parametrize(
    "method", ["systematic", "stratified", "multinomial", "metropolis"]
)
def test_resamplers_all_unbiased(method):
    # "metropolis" runs per-shard chains over the gathered global weights
    # (its collective-free design point; ops/resampling.py) — included so
    # the sharded likelihood estimator's unbiasedness is pinned for it too.
    truth = kalman_loglik(Y, A, C, SX, SY)
    mesh = make_chain_mesh(8, particle_axis_size=2)
    ll, _ = run(mesh, num_chains=32, num_particles=512,
                resample_algorithm="SISR", resample_fn=method)
    lls = np.asarray(ll, dtype=np.float64)
    assert abs(lls.mean() - truth) < 0.35


def test_state_estimates_track_truth():
    x, y_long = simulate_lgss(9, t_val=30, a=A, sigma_x=SX, sigma_y=SY)
    mesh = make_chain_mesh(8, particle_axis_size=4)
    theta = {k: v[:4] for k, v in THETA8.items()}
    ll, states = sharded_bootstrap_filter(
        jax.random.key(5), y_long, 512, INIT_FN, TRANSITION_FN, LOGLIK_FN,
        theta, num_chains=4, mesh=mesh, resample_algorithm="SISR",
    )
    est = np.asarray(states)[:, :, 0].mean(axis=0)
    rmse = np.sqrt(np.mean((est - x[1:]) ** 2))
    assert rmse < 0.5


def test_divisibility_errors():
    mesh = make_chain_mesh(8, particle_axis_size=4)
    with pytest.raises(ValueError, match="divide"):
        run(mesh, num_chains=3)
    with pytest.raises(ValueError, match="divide"):
        run(mesh, num_particles=101)


# ---- unified-core features under particle sharding ----
# These run through bayesssm_tpu.parallel.sharded.sharded_particle_filter,
# which is now a thin shard_map wrapper over filters/core.py (one engine,
# VERDICT round-1 item 4): every core feature must hold under sharding.

from bayesssm_tpu.filters.auxiliary import auxiliary_filter
from bayesssm_tpu.filters.core import particle_filter_core
from bayesssm_tpu.parallel.sharded import sharded_particle_filter


def aux_loglik_fn(y, particles, a, sigma_x, sigma_y):
    # One-step-ahead lookahead mean, the usual APF auxiliary weight.
    return -0.5 * (
        jnp.log(2 * jnp.pi * SY_AUX**2)
        + ((y - a * particles) / SY_AUX) ** 2
    )


SY_AUX = np.sqrt(SX**2 + SY**2)


def test_sharded_apf_matches_unsharded_distribution():
    # The sharded APF path (collective aux normalize + distributed aux
    # resample + Q2 double transition) must estimate the same quantity as
    # the unsharded APF: means over independent chains agree within MC
    # error. One sharded call (32 chains) and one vmapped unsharded call.
    mesh = make_chain_mesh(8, particle_axis_size=4)
    ll, _ = sharded_particle_filter(
        jax.random.key(0), Y, 512, INIT_FN, TRANSITION_FN, LOGLIK_FN,
        theta_for(32), num_chains=32, mesh=mesh, algorithm="APF",
        aux_log_likelihood_fn=aux_loglik_fn, resample_algorithm="SISR",
    )
    ll_sharded = np.asarray(ll, dtype=np.float64)

    theta1 = {"a": A, "sigma_x": SX, "sigma_y": SY}

    @jax.jit
    def plain(keys):
        def one(k):
            return auxiliary_filter(
                k, Y, 512, INIT_FN, TRANSITION_FN,
                LOGLIK_FN, aux_loglik_fn, theta=theta1,
                resample_algorithm="SISR", return_particles=False,
            ).loglike
        return jax.vmap(one)(keys)

    ll_plain = np.asarray(
        plain(jax.random.split(jax.random.key(100), 16)), dtype=np.float64
    )
    se = np.sqrt(
        ll_sharded.var() / len(ll_sharded) + ll_plain.var() / len(ll_plain)
    )
    assert abs(ll_sharded.mean() - ll_plain.mean()) < max(4 * se, 0.3)


def test_sharded_rmpf_runs_and_tracks():
    x, y_long = simulate_lgss(21, t_val=25, a=A, sigma_x=SX, sigma_y=SY)

    def move_fn(key, particles, y, sigma_y):
        k1, k2 = jax.random.split(key)
        prop = particles + 0.2 * jax.random.normal(k1, particles.shape)
        logr = LOGLIK_FN(y, prop, sigma_y=sigma_y) - \
            LOGLIK_FN(y, particles, sigma_y=sigma_y)
        accept = jnp.log(jax.random.uniform(k2, particles.shape)) < logr
        return jnp.where(accept, prop, particles)

    mesh = make_chain_mesh(8, particle_axis_size=2)
    theta4 = {k: v[:4] for k, v in THETA8.items()}
    ll, states = sharded_particle_filter(
        jax.random.key(2), y_long, 256, INIT_FN, TRANSITION_FN, LOGLIK_FN,
        theta4, num_chains=4, mesh=mesh, algorithm="RMPF", move_fn=move_fn,
    )
    assert np.isfinite(np.asarray(ll)).all()
    est = np.asarray(states)[:, :, 0].mean(axis=0)
    rmse = np.sqrt(np.mean((est - x[1:]) ** 2))
    assert rmse < 0.5


def test_sharded_obs_times_gaps():
    # Irregular observation times under sharding: loglike must match the
    # Kalman filter evaluated on the same gap structure (SISR, unbiased).
    obs_times = [1, 3, 4, 7]
    rng = np.random.default_rng(11)
    x = rng.normal()
    xs, ys_obs = [], []
    t_now = 0
    for t in obs_times:
        for _ in range(t - t_now):
            x = A * x + SX * rng.normal()
        t_now = t
        ys_obs.append(C_OBS * x + SY * rng.normal())
    ys_obs = np.asarray(ys_obs, dtype=np.float64)

    # Kalman with gap structure: absorb skipped steps into the prediction.
    import math
    mean, var = 0.0, 1.0
    truth = 0.0
    t_prev = 0
    for j, t in enumerate(obs_times):
        for _ in range(t - t_prev):
            mean, var = A * mean, A * A * var + SX**2
        t_prev = t
        s = C_OBS * C_OBS * var + SY**2
        truth += -0.5 * (math.log(2 * math.pi * s) + (ys_obs[j] - C_OBS * mean) ** 2 / s)
        k_gain = var * C_OBS / s
        mean = mean + k_gain * (ys_obs[j] - C_OBS * mean)
        var = (1 - k_gain * C_OBS) * var

    mesh = make_chain_mesh(8, particle_axis_size=4)
    ll, _ = sharded_particle_filter(
        jax.random.key(0), ys_obs, 512, INIT_FN, TRANSITION_FN,
        LOGLIK_FN, theta_for(32), num_chains=32, mesh=mesh,
        obs_times=obs_times, resample_algorithm="SISR",
    )
    lls = np.asarray(ll, dtype=np.float64)
    assert abs(lls.mean() - truth) < 0.3


C_OBS = 1.0


def test_sharded_masked_particle_counts():
    # Traced num_particles below the static bound inside shard_map: global
    # masked lanes must never contaminate the estimate. Compare against the
    # Kalman truth with the reduced count.
    truth = kalman_loglik(Y, A, C, SX, SY)
    mesh = make_chain_mesh(8, particle_axis_size=4)
    theta1 = {k: v[:1] for k, v in THETA8.items()}

    from jax.sharding import PartitionSpec as P
    from jax import shard_map, lax

    def shard_fn():
        ck = jax.random.fold_in(jax.random.key(0), 0)
        res = particle_filter_core(
            ck, Y, jnp.asarray(384), INIT_FN, TRANSITION_FN, LOGLIK_FN,
            theta={"a": A, "sigma_x": SX, "sigma_y": SY},
            resample_algorithm="SISR", return_particles=False,
            max_particles=512,
            particle_axis="particles", particle_axis_size=4,
        )
        return res.loglike[None]

    fn = shard_map(
        shard_fn, mesh=mesh, in_specs=(), out_specs=P(), check_vma=False,
    )
    ll = float(np.asarray(fn())[0])
    assert np.isfinite(ll)
    assert abs(ll - truth) < 3.0  # single run, loose sanity band
