"""Builder-instance SIR whole sweep (models/sir.py::sir_builder_pf_impl).

The SIR filter expressed through the generic sweep builder's callbacks
(ops/sir_sweep_pallas.py) — exact Gillespie day via the callback
while_loop with explicit RNG-counter threading, Poisson weights with a
precomputed ``lgamma(y+1)`` observation column, packed (S, I)
selection. Validated distributionally against the plain engine in
interpret mode; chip_smoke.py compares it compiled at real widths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bayesssm_tpu.filters.auxiliary import auxiliary_filter
from bayesssm_tpu.filters.bootstrap import bootstrap_filter
from bayesssm_tpu.filters.resample_move import resample_move_filter
from bayesssm_tpu.models.sir import (
    simulate_sir,
    sir_aux_log_likelihood_fn,
    sir_builder_pf_impl,
    sir_model,
    sir_move_fn,
    sir_sweep_pf_impl,
)

N_TOTAL, I0 = 500, 70
LAM, GAM = 0.5, 0.2
N = 128


@pytest.fixture(scope="module")
def ys():
    _, y = simulate_sir(1405, N_TOTAL, I0, t_max=8, lam=LAM, gamma=GAM)
    return jnp.asarray(y, jnp.float32)


def _impl_batch(impl_factory, ys, c, key=0, algorithm="BPF",
                resample_algorithm="SISAR", num_particles=N):
    pf = impl_factory(
        y=ys, num_particles=num_particles,
        param_names=["lam", "gamma"], model_fns=None, obs_times=None,
        algorithm=algorithm, resample_algorithm=resample_algorithm,
        resample_fn="stratified", carry_weights=False,
    )
    keys = jax.random.split(jax.random.key(key), c)
    theta = jnp.array([LAM, GAM], jnp.float32)
    return jax.jit(jax.vmap(lambda k: pf(k, theta)))(keys)


def _portable_batch(ys, c, key=1, algorithm="BPF",
                    resample_algorithm="SISAR"):
    (init_fn, trans_fn, loglik_fn), _, _ = sir_model(N_TOTAL, I0)
    theta = {"lam": LAM, "gamma": GAM}
    keys = jax.random.split(jax.random.key(key), c)

    def one(k):
        if algorithm == "APF":
            r = auxiliary_filter(
                k, ys, N, init_fn, trans_fn, loglik_fn,
                aux_log_likelihood_fn=sir_aux_log_likelihood_fn,
                theta=theta, return_particles=False,
            )
        elif algorithm == "RMPF":
            r = resample_move_filter(
                k, ys, N, init_fn, trans_fn, loglik_fn,
                move_fn=sir_move_fn(N_TOTAL), theta=theta,
                return_particles=False,
            )
        else:
            r = bootstrap_filter(
                k, ys, N, init_fn, trans_fn, loglik_fn, theta=theta,
                return_particles=False,
                resample_algorithm=resample_algorithm,
            )
        return r.loglike, r.state_est

    return jax.jit(jax.vmap(one))(keys)


def _match(ll_s, es_s, ll_c, es_c, c, est_atol=6.0):
    assert bool(jnp.isfinite(ll_s).all())
    se_tol = 4.0 * float(
        np.hypot(np.std(np.asarray(ll_s)), np.std(np.asarray(ll_c)))
    ) / np.sqrt(c)
    assert abs(float(ll_s.mean() - ll_c.mean())) < max(se_tol, 0.25)
    np.testing.assert_allclose(
        np.asarray(es_s.mean(axis=0)), np.asarray(es_c.mean(axis=0)),
        atol=est_atol,
    )


@pytest.mark.parametrize("algorithm", ["BPF", "APF", "RMPF"])
def test_matches_portable(ys, algorithm):
    c = 128
    ll_b, es_b = _impl_batch(
        sir_builder_pf_impl(N_TOTAL, I0, interpret=True), ys, c,
        key=2, algorithm=algorithm,
    )
    ll_c, es_c = _portable_batch(ys, c, key=3, algorithm=algorithm)
    _match(ll_b, es_b, ll_c, es_c, c)


def test_sweep_pf_impl_is_builder_backed(ys):
    """Since the round-5 consolidation the legacy name and the builder
    factory are the SAME callable; the direct sir_filter_sweep entry
    (build_sweep_op wiring, not the pf_impl route) must sample the same
    distribution."""
    from bayesssm_tpu.ops.sir_sweep_pallas import sir_filter_sweep

    assert sir_sweep_pf_impl is sir_builder_pf_impl
    c = 128
    ll_b, es_b = _impl_batch(
        sir_builder_pf_impl(N_TOTAL, I0, interpret=True), ys, c, key=4
    )
    keys = jax.random.split(jax.random.key(5), c)
    ll_k, es_k = jax.jit(jax.vmap(
        lambda k: sir_filter_sweep(
            k, ys, N, LAM, GAM, N_TOTAL, I0, interpret=True
        )
    ))(keys)
    _match(ll_b, es_b, ll_k, es_k, c)


def test_deterministic_per_key(ys):
    ll1, es1 = _impl_batch(
        sir_builder_pf_impl(N_TOTAL, I0, interpret=True), ys, 8, key=6
    )
    ll2, es2 = _impl_batch(
        sir_builder_pf_impl(N_TOTAL, I0, interpret=True), ys, 8, key=6
    )
    np.testing.assert_array_equal(np.asarray(ll1), np.asarray(ll2))
    np.testing.assert_array_equal(np.asarray(es1), np.asarray(es2))


def test_unpacked_route_matches(ys):
    """Packing is purely a selection-throughput optimization: the
    packed (S, I) route and the raw two-column route (pack=False — the
    path large populations take) must sample the same distribution."""
    from bayesssm_tpu.ops.sir_sweep_pallas import sir_sweep_parts

    # The switch really disables packing (a review found an earlier
    # version of this test exercised the packed route twice).
    assert sir_sweep_parts(N_TOTAL, I0, pack=False)["pack_kw"] == {}
    assert sir_sweep_parts(N_TOTAL, I0)["pack_kw"] != {}
    c = 96
    ll_p, es_p = _impl_batch(
        sir_builder_pf_impl(N_TOTAL, I0, interpret=True), ys, c, key=7
    )
    ll_u, es_u = _impl_batch(
        sir_builder_pf_impl(N_TOTAL, I0, interpret=True, pack=False),
        ys, c, key=8,
    )
    _match(ll_p, es_p, ll_u, es_u, c)


def test_pmmh_pf_impl_hook(ys):
    from bayesssm_tpu import default_tune_control, pmmh

    (init_fn, trans_fn, loglik_fn), log_priors, transform = sir_model(
        N_TOTAL, I0
    )
    out = pmmh(
        "bootstrap_filter", np.asarray(ys), 16,
        init_fn, trans_fn, loglik_fn, log_priors,
        pilot_init_params=[{"lam": 0.4, "gamma": 0.25}] * 2,
        burn_in=4, num_chains=2, param_transform=transform, seed=29,
        tune_control=default_tune_control(
            pilot_m=16, pilot_burn_in=4, pilot_reps=3
        ),
        print_summary=False,
        pf_impl=sir_builder_pf_impl(N_TOTAL, I0, interpret=True),
    )
    for p, chain in out.theta_chain.items():
        assert chain.shape == (2, 12), (p, chain.shape)
        assert np.isfinite(chain).all(), p


def test_obs_times_gaps_match_portable(ys):
    """Irregular observation grid through the builder's in-kernel gap
    loop vs the portable engine's gap loop
    (/root/reference/R/particle_filter_core.R:122-137) — same sampling
    distribution (the SIR transition is time-homogeneous, so the gap
    semantics are purely 'how many Gillespie days per observation')."""
    obs_times = [1, 3, 4, 6, 8, 9]
    y_g = ys[: len(obs_times)]
    c = 128
    pf = sir_builder_pf_impl(N_TOTAL, I0, interpret=True)(
        y=y_g, num_particles=N, param_names=["lam", "gamma"],
        model_fns=None, obs_times=obs_times, algorithm="BPF",
        resample_algorithm="SISAR", resample_fn="stratified",
        carry_weights=False,
    )
    theta = jnp.array([LAM, GAM], jnp.float32)
    keys = jax.random.split(jax.random.key(51), c)
    ll_b, es_b = jax.jit(jax.vmap(lambda k: pf(k, theta)))(keys)

    (init_fn, trans_fn, loglik_fn), _, _ = sir_model(N_TOTAL, I0)
    keys2 = jax.random.split(jax.random.key(52), c)
    res = jax.jit(jax.vmap(
        lambda k: bootstrap_filter(
            k, y_g, N, init_fn, trans_fn, loglik_fn,
            theta={"lam": LAM, "gamma": GAM}, obs_times=obs_times,
            return_particles=False,
        ).loglike
    ))(keys2)
    assert bool(jnp.isfinite(ll_b).all())
    assert es_b.shape == (c, len(obs_times) + 1, 2)
    se_tol = 4.0 * float(
        np.hypot(np.std(np.asarray(ll_b)), np.std(np.asarray(res)))
    ) / np.sqrt(c)
    assert abs(float(ll_b.mean() - res.mean())) < max(se_tol, 0.25)


def test_param_names_any_order(ys):
    """The factory accepts the driver's param order (whatever order the
    user's log_priors dict iterates) and permutes theta onto the
    builder's canonical order — for the same key the two orderings are
    BIT-identical (review regression: the consolidation briefly
    narrowed this to exact-order)."""
    kw = dict(
        y=ys, num_particles=N, model_fns=None, obs_times=None,
        algorithm="BPF", resample_algorithm="SISAR",
        resample_fn="stratified", carry_weights=False,
    )
    pf_fwd = sir_builder_pf_impl(N_TOTAL, I0, interpret=True)(
        param_names=["lam", "gamma"], **kw
    )
    pf_rev = sir_builder_pf_impl(N_TOTAL, I0, interpret=True)(
        param_names=["gamma", "lam"], **kw
    )
    key = jax.random.key(71)
    ll_f, es_f = pf_fwd(key, jnp.array([LAM, GAM], jnp.float32))
    ll_r, es_r = pf_rev(key, jnp.array([GAM, LAM], jnp.float32))
    np.testing.assert_array_equal(np.asarray(ll_f), np.asarray(ll_r))
    np.testing.assert_array_equal(np.asarray(es_f), np.asarray(es_r))
