"""Contracts of the plain filter engine (filters/core.py) on the
linear-Gaussian model, whose log-marginal likelihood is exact
(utils/kalman.py).

Each bootstrap and resample-move configuration must give an unbiased
log-likelihood estimate; every configuration must give finite histories
of the right shape, bit-reproducible results per key, and ancestors
drawn from the alive lanes only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bayesssm_tpu.filters.core import particle_filter_core
from bayesssm_tpu.utils.kalman import kalman_loglik

A, C, SX, SY = 0.9, 1.0, 0.6, 0.4
N = 128


def lgss_init(key, num_particles):
    return jax.random.normal(key, (num_particles,))


def lgss_transition(key, particles, t):
    return A * particles + SX * jax.random.normal(key, particles.shape)


def lgss_loglik(y, particles, t):
    return -0.5 * (jnp.log(2 * jnp.pi * SY**2) + ((y - C * particles) / SY) ** 2)


def lgss_move(key, particles, y, t):
    # MH rejuvenation targeting the observation density; the move comes
    # after the weighting, so it leaves the estimator unbiased.
    k_prop, k_acc = jax.random.split(key)
    prop = particles + 0.3 * jax.random.normal(k_prop, particles.shape)
    logr = lgss_loglik(y, prop, t) - lgss_loglik(y, particles, t)
    accept = jnp.log(jax.random.uniform(k_acc, particles.shape)) < logr
    return jnp.where(accept, prop, particles)


def lgss_init2d(key, num_particles):
    return jax.random.normal(key, (num_particles, 2))


def lgss_transition2d(key, particles, t):
    return A * particles + SX * jax.random.normal(key, particles.shape)


def lgss_loglik2d(y, particles, t):
    return lgss_loglik(y, particles[:, 0], t)


BPF_KW = dict(
    init_fn=lgss_init, transition_fn=lgss_transition, weight_fn=lgss_loglik,
)


@pytest.fixture(scope="module")
def ys():
    rng = np.random.default_rng(1405)
    x = rng.normal()
    out = []
    for _ in range(12):
        x = A * x + SX * rng.normal()
        out.append(C * x + SY * rng.normal())
    return np.array(out, dtype=np.float32)


CASES = {
    "bpf-sisr-stratified": dict(resample_algorithm="SISR", **BPF_KW),
    "bpf-sisr-systematic": dict(
        resample_algorithm="SISR", resample_fn="systematic", **BPF_KW
    ),
    "bpf-sisar-carry": dict(carry_weights=True, **BPF_KW),
    "rmpf": dict(algorithm="RMPF", move_fn=lgss_move, **BPF_KW),
    "bpf-2d-state": dict(
        resample_algorithm="SISR", init_fn=lgss_init2d,
        transition_fn=lgss_transition2d, weight_fn=lgss_loglik2d,
    ),
    "bpf-masked-96-of-128": dict(
        resample_algorithm="SISR", max_particles=N, **BPF_KW
    ),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_loglike_matches_kalman(ys, case):
    """The mean log-likelihood over 64 filters lies within 5 standard
    errors of the exact Kalman value; histories are finite."""
    kw = dict(CASES[case])
    n = jnp.asarray(96) if "masked" in case else N
    keys = jax.random.split(jax.random.key(7), 64)
    res = jax.jit(jax.vmap(
        lambda k: particle_filter_core(k, ys, n, return_particles=False, **kw)
    ))(keys)
    ll = np.asarray(res.loglike, np.float64)
    truth = kalman_loglik(ys, A, C, SX, SY, p0=1.0)
    se = ll.std() / np.sqrt(len(ll))
    assert np.isfinite(ll).all()
    assert abs(ll.mean() - truth) < 5 * se + 0.05, (ll.mean(), truth, se)
    t = len(ys)
    assert res.ess.shape == (64, t + 1)
    assert res.loglike_history.shape == (64, t)
    assert np.isfinite(np.asarray(res.state_est)).all()


APF_KW = dict(algorithm="APF", aux_weight_fn=lgss_loglik, **BPF_KW)


@pytest.mark.parametrize("carry_weights", [False, True])
def test_apf_runs_finite(ys, carry_weights):
    """The APF propagates twice per observation (the reference's quirk
    Q2), so its estimate does not target the Kalman value; it must still
    be finite with finite histories."""
    res = particle_filter_core(
        jax.random.key(5), ys, N, carry_weights=carry_weights, **APF_KW
    )
    assert np.isfinite(float(res.loglike))
    assert np.isfinite(np.asarray(res.loglike_history)).all()
    assert np.isfinite(np.asarray(res.state_est)).all()
    assert (np.asarray(res.ess) > 0).all()


@pytest.mark.parametrize("case", ["bpf-sisr-stratified", "apf", "rmpf"])
def test_deterministic_per_key(ys, case):
    kw = APF_KW if case == "apf" else CASES[case]
    r1 = particle_filter_core(jax.random.key(9), ys, N, **kw)
    r2 = particle_filter_core(jax.random.key(9), ys, N, **kw)
    np.testing.assert_array_equal(np.asarray(r1.loglike), np.asarray(r2.loglike))
    np.testing.assert_array_equal(
        np.asarray(r1.state_est), np.asarray(r2.state_est)
    )
    np.testing.assert_array_equal(
        np.asarray(r1.particles_history), np.asarray(r2.particles_history)
    )


def test_chains_decorrelated(ys):
    r1 = particle_filter_core(jax.random.key(1), ys, N, **BPF_KW)
    r2 = particle_filter_core(jax.random.key(2), ys, N, **BPF_KW)
    assert float(r1.loglike) != float(r2.loglike)


@pytest.mark.parametrize("resample_fn", ["stratified", "systematic", "multinomial"])
def test_masked_lanes_never_selected(ys, resample_fn):
    """Ancestors come from the alive range only: every particle with
    positive weight carries a tag below the alive count."""
    alive = 96

    def init_tagged(key, num_particles):
        return jnp.arange(num_particles, dtype=jnp.float32)

    def trans_id(key, particles, t):
        return particles

    def loglik_flat(y, particles, t):
        return jnp.zeros_like(particles)

    res = particle_filter_core(
        jax.random.key(4), ys[:3], jnp.asarray(alive),
        init_tagged, trans_id, loglik_flat,
        max_particles=N, resample_algorithm="SISR", resample_fn=resample_fn,
    )
    hist = np.asarray(res.particles_history)
    w = np.asarray(res.weights_history)
    assert (hist[w > 0] < alive).all()
    assert (w[:, alive:] == 0).all()
