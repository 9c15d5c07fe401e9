"""APF and RMPF behavioral tests.

Mirrors /root/reference/tests/testthat/test-auxiliary_filter.R (APF beats
BPF on state-estimation MSE under informative observations) and
test-resample_move_filter.R (RMPF beats BPF under strong degeneracy), run
over several seeds since single-seed comparisons are noisy.
"""

import jax
import jax.numpy as jnp
import numpy as np

from bayesssm_tpu.filters.auxiliary import auxiliary_filter
from bayesssm_tpu.filters.bootstrap import bootstrap_filter
from bayesssm_tpu.filters.resample_move import resample_move_filter

MU, SIGMA = 1.0, 0.1
THETA = {"mu": MU, "sigma": SIGMA}


def simulate_drift(seed, T=50, sigma=SIGMA):
    rng = np.random.default_rng(seed)
    x = np.zeros(T + 1)
    y = np.zeros(T)
    x[0] = rng.normal()
    for t in range(T):
        x[t + 1] = x[t] + rng.normal(MU)
        y[t] = rng.normal(x[t + 1], sigma)
    return x, y


def init_fn(key, num_particles):
    return jax.random.normal(key, (num_particles,))


def transition_fn(key, particles, mu):
    return particles + mu + jax.random.normal(key, particles.shape)


def loglik_fn(y, particles, sigma):
    return -0.5 * (jnp.log(2 * jnp.pi * sigma**2) + ((y - particles) / sigma) ** 2)


def aux_loglik_fn(y, particles, mu, sigma):
    return loglik_fn(y, particles + mu, sigma)


def move_fn(key, particles, y, sigma):
    k1, k2 = jax.random.split(key)
    proposal = particles + 0.1 * jax.random.normal(k1, particles.shape)
    log_alpha = loglik_fn(y, proposal, sigma) - loglik_fn(y, particles, sigma)
    accept = jnp.log(jax.random.uniform(k2, particles.shape)) < log_alpha
    return jnp.where(accept, proposal, particles)


def test_apf_beats_bpf_mse():
    wins = 0
    for seed in range(5):
        x, y = simulate_drift(seed)
        bpf = bootstrap_filter(
            jax.random.key(seed), y, 20, init_fn, transition_fn, loglik_fn,
            theta=THETA, return_particles=False,
        )
        apf = auxiliary_filter(
            jax.random.key(seed + 100), y, 20, init_fn, transition_fn,
            loglik_fn, aux_loglik_fn, theta=THETA, return_particles=False,
        )
        mse_bpf = np.mean((np.asarray(bpf.state_est) - x) ** 2)
        mse_apf = np.mean((np.asarray(apf.state_est) - x) ** 2)
        wins += mse_apf < mse_bpf
    assert wins >= 3


def test_rmpf_beats_bpf_mse():
    wins = 0
    for seed in range(5):
        x, y = simulate_drift(seed, sigma=0.05)
        theta = {"mu": MU, "sigma": 0.05}
        bpf = bootstrap_filter(
            jax.random.key(seed), y, 20, init_fn, transition_fn, loglik_fn,
            theta=theta, return_particles=False,
        )
        rmpf = resample_move_filter(
            jax.random.key(seed + 100), y, 20, init_fn, transition_fn,
            loglik_fn, move_fn, theta=theta, return_particles=False,
        )
        mse_bpf = np.mean((np.asarray(bpf.state_est) - x) ** 2)
        mse_rmpf = np.mean((np.asarray(rmpf.state_est) - x) ** 2)
        wins += mse_rmpf < mse_bpf
    assert wins >= 3


def test_rmpf_always_resamples():
    _, y = simulate_drift(7)
    res = resample_move_filter(
        jax.random.key(0), y, 32, init_fn, transition_fn, loglik_fn, move_fn,
        theta=THETA,
    )
    # SISR forced: recorded ESS is always n (Q4).
    np.testing.assert_allclose(np.asarray(res.ess), 32.0)
    assert res.algorithm == "RMPF"
    assert res.resample_algorithm == "SISR"


def test_apf_uses_lookahead_weights():
    # A pathological lookahead that concentrates all auxiliary weight on one
    # particle must change the result vs BPF with the same key.
    _, y = simulate_drift(3)
    apf = auxiliary_filter(
        jax.random.key(5), y, 64, init_fn, transition_fn, loglik_fn,
        aux_loglik_fn, theta=THETA, return_particles=False,
    )
    bpf = bootstrap_filter(
        jax.random.key(5), y, 64, init_fn, transition_fn, loglik_fn,
        theta=THETA, return_particles=False,
    )
    assert not np.allclose(np.asarray(apf.state_est), np.asarray(bpf.state_est))
    assert np.isfinite(float(apf.loglike))


def test_apf_degenerate_aux_weights_give_neg_inf():
    """Degenerate AUX weights kill the chain like degenerate main weights.

    Without the aux-degeneracy dead flag a clamp of the aux weights would
    cancel in ``lw - aux_anc`` and a dead proposal would surface a
    spuriously huge log-likelihood. The reference's sample() would error
    on all-zero auxiliary probabilities; the repo maps it to the -inf
    contract."""
    _, y = simulate_drift(3, T=8)

    def bad_aux_fn(y, particles, mu, sigma):
        return jnp.full(particles.shape[0], -1.0e12)

    res = auxiliary_filter(
        jax.random.key(5), y, 128, init_fn, transition_fn, loglik_fn,
        bad_aux_fn, theta=THETA, return_particles=False,
    )
    ll = float(res.loglike)
    assert np.isinf(ll) and ll < 0, ll


def single_particle_move_fn(key, particle, y, sigma):
    """Reference-style per-particle move (R core calls move_fn(particle=...),
    /root/reference/R/particle_filter_core.R:226-234); auto-vmapped by
    utils/signatures.py::adapt_move_fn."""
    k1, k2 = jax.random.split(key)
    proposal = particle + 0.1 * jax.random.normal(k1, particle.shape)
    log_alpha = loglik_fn(y, proposal, sigma) - loglik_fn(y, particle, sigma)
    accept = jnp.log(jax.random.uniform(k2)) < log_alpha
    return jnp.where(accept, proposal, particle)


def test_single_particle_move_fn_runs_unchanged():
    # A straight port of a reference-style move function (declaring
    # `particle`, singular) must run without modification.
    x, y = simulate_drift(3, sigma=0.05)
    theta = {"mu": MU, "sigma": 0.05}
    res = resample_move_filter(
        jax.random.key(11), y, 24, init_fn, transition_fn, loglik_fn,
        single_particle_move_fn, theta=theta, return_particles=False,
    )
    assert np.isfinite(float(res.loglike))
    # The rejuvenated filter still tracks the drifting state.
    rmse = np.sqrt(np.mean((np.asarray(res.state_est) - x) ** 2))
    assert rmse < 0.5


def test_single_particle_move_deterministic_matches_vectorized():
    # With a deterministic move, the per-particle shim must produce exactly
    # the vectorized result (key handling differs only for random moves).
    _, y = simulate_drift(5)

    def move_vec(particles, y, mu):
        return particles + 0.0 * mu

    def move_single(particle, y, mu):
        return particle + 0.0 * mu

    a = resample_move_filter(
        jax.random.key(2), y, 16, init_fn, transition_fn, loglik_fn,
        move_vec, theta=THETA, return_particles=True,
    )
    b = resample_move_filter(
        jax.random.key(2), y, 16, init_fn, transition_fn, loglik_fn,
        move_single, theta=THETA, return_particles=True,
    )
    np.testing.assert_array_equal(
        np.asarray(a.particles_history), np.asarray(b.particles_history)
    )
    np.testing.assert_array_equal(float(a.loglike), float(b.loglike))


def test_single_particle_move_matrix_state():
    # Matrix particles: the shim passes each ROW (the reference's
    # particles[j, ]) to the user function.
    _, y = simulate_drift(9)

    def init2(key, num_particles):
        return jax.random.normal(key, (num_particles, 2))

    def trans2(key, particles, mu):
        return particles + mu + jax.random.normal(key, particles.shape)

    def loglik2(y, particles, sigma):
        return -0.5 * (
            jnp.log(2 * jnp.pi * sigma**2)
            + ((y - particles[..., 0]) / sigma) ** 2
        )

    rows_seen = []

    def move_single(key, particle, y):
        rows_seen.append(particle.shape)
        return particle + 0.01 * jax.random.normal(key, particle.shape)

    res = resample_move_filter(
        jax.random.key(4), y, 16, init2, trans2, loglik2, move_single,
        theta=THETA,
    )
    assert np.isfinite(float(res.loglike))
    assert all(s == (2,) for s in rows_seen)  # row view, not the matrix
