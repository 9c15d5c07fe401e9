"""Whole-sweep SIR kernel (ops/sir_sweep_pallas.py), interpret mode.

The sweep kernel must sample from the same distribution as the generic
engine (filters/core.py) running the SIR model with fresh-weight SISAR —
the reference BPF semantics (/root/reference/R/particle_filter_core.R:
123-246). Bit-streams differ (in-kernel PRNG vs threefry), so equivalence
is distributional.
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
    sir_model,
    sir_move_fn,
)
from bayesssm_tpu.ops.sir_sweep_pallas import sir_bpf_sweep, sir_filter_sweep

N_TOTAL, I0, N = 100, 10, 128
LAM, GAM = 0.4, 0.25


@pytest.fixture(scope="module")
def ys():
    _, y = simulate_sir(seed=7, n_total=N_TOTAL, init_infected=I0, t_max=6)
    return jnp.asarray(y, jnp.float32)


def _sweep_batch(ys, c, key=0, **kw):
    keys = jax.random.split(jax.random.key(key), c)

    def one(k):
        return sir_filter_sweep(
            k, ys, kw.pop("num_particles", N), LAM, GAM, N_TOTAL, I0,
            interpret=True, **kw,
        )

    return jax.jit(jax.vmap(one))(keys)


def _core_batch(ys, c, key=1, num_particles=N, max_particles=None,
                algorithm="BPF"):
    (init_fn, transition_fn, loglik_fn), _, _ = sir_model(
        n_total=N_TOTAL, init_infected=I0
    )
    keys = jax.random.split(jax.random.key(key), c)
    theta = {"lam": LAM, "gamma": GAM}

    def one(k):
        if algorithm == "APF":
            r = auxiliary_filter(
                k, ys, num_particles, init_fn, transition_fn, loglik_fn,
                aux_log_likelihood_fn=sir_aux_log_likelihood_fn,
                theta=theta, return_particles=False,
                max_particles=max_particles,
            )
        elif algorithm == "RMPF":
            r = resample_move_filter(
                k, ys, num_particles, init_fn, transition_fn, loglik_fn,
                move_fn=sir_move_fn(N_TOTAL), theta=theta,
                return_particles=False, max_particles=max_particles,
            )
        else:
            r = bootstrap_filter(
                k, ys, num_particles, init_fn, transition_fn, loglik_fn,
                theta=theta, return_particles=False,
                max_particles=max_particles,
            )
        return r.loglike, r.state_est

    return jax.jit(jax.vmap(one))(keys)


def _assert_distributional_match(ll_s, se_s, ll_c, se_c, c):
    assert bool(jnp.isfinite(ll_s).all())
    se_tol = 4.0 * float(
        np.hypot(np.std(np.asarray(ll_s)), np.std(np.asarray(ll_c)))
    ) / np.sqrt(c)
    assert abs(float(ll_s.mean() - ll_c.mean())) < se_tol
    np.testing.assert_allclose(
        np.asarray(se_s.mean(axis=0)), np.asarray(se_c.mean(axis=0)),
        rtol=0.05, atol=0.5,
    )


def test_matches_core_filter_distributionally(ys):
    c = 192
    ll_s, se_s = _sweep_batch(ys, c)
    ll_c, se_c = _core_batch(ys, c)
    # Unbiased log-likelihood estimators of the same marginal likelihood:
    # means agree within a few combined standard errors; filtered state
    # trajectories agree within MC error.
    _assert_distributional_match(ll_s, se_s, ll_c, se_c, c)


def test_apf_matches_core_filter_distributionally(ys):
    """Sweep APF vs the generic engine's APF (Q2 double transition,
    aux resample, corrected weights) — same sampling distribution."""
    c = 192
    ll_s, se_s = _sweep_batch(ys, c, key=21, algorithm="APF")
    ll_c, se_c = _core_batch(ys, c, key=22, algorithm="APF")
    _assert_distributional_match(ll_s, se_s, ll_c, se_c, c)


def test_rmpf_matches_core_filter_distributionally(ys):
    """Sweep RMPF vs the generic engine's RMPF (forced SISR + Metropolis
    rejuvenation move on I) — same sampling distribution."""
    c = 192
    ll_s, se_s = _sweep_batch(ys, c, key=23, algorithm="RMPF")
    ll_c, se_c = _core_batch(ys, c, key=24, algorithm="RMPF")
    _assert_distributional_match(ll_s, se_s, ll_c, se_c, c)


def test_apf_rmpf_masked_lanes(ys):
    """Traced num_particles under the static bound, APF/RMPF variants."""
    c = 160
    keys = jax.random.split(jax.random.key(25), c)
    for algorithm in ("APF", "RMPF"):
        def one(k, n_alive):
            return sir_filter_sweep(
                k, ys, n_alive, LAM, GAM, N_TOTAL, I0, max_particles=N,
                algorithm=algorithm, interpret=True,
            )

        ll_m, _ = jax.jit(jax.vmap(one))(keys, jnp.full((c,), 64.0))
        ll_c, _ = _core_batch(
            ys, c, key=26, num_particles=64, algorithm=algorithm
        )
        assert bool(jnp.isfinite(ll_m).all()), algorithm
        se_tol = 4.0 * float(
            np.hypot(np.std(np.asarray(ll_m)), np.std(np.asarray(ll_c)))
        ) / np.sqrt(c)
        assert abs(float(ll_m.mean() - ll_c.mean())) < se_tol, algorithm


def test_merge_selection_matches_core(ys):
    """The kernel's inverse-CDF selection (a binary search over the
    CDF) samples the same distribution as the generic engine; masked
    lanes included."""
    c = 192
    ll_s, se_s = _sweep_batch(ys, c, key=31)
    ll_c, se_c = _core_batch(ys, c, key=32)
    _assert_distributional_match(ll_s, se_s, ll_c, se_c, c)

    keys = jax.random.split(jax.random.key(33), c)

    def one(k, n_alive):
        return sir_filter_sweep(
            k, ys, n_alive, LAM, GAM, N_TOTAL, I0, max_particles=N,
            interpret=True,
        )

    ll_m, _ = jax.jit(jax.vmap(one))(keys, jnp.full((c,), 64.0))
    ll_c64, _ = _core_batch(ys, c, key=34, num_particles=64)
    assert bool(jnp.isfinite(ll_m).all())
    se_tol = 4.0 * float(
        np.hypot(np.std(np.asarray(ll_m)), np.std(np.asarray(ll_c64)))
    ) / np.sqrt(c)
    assert abs(float(ll_m.mean() - ll_c64.mean())) < se_tol


def test_merge_selection_validation(ys):
    """Selection searches sorted positions: multinomial (unsorted) draws
    are refused by the entry point and by the pf_impl factory."""
    with pytest.raises(ValueError, match="sorted positions"):
        sir_filter_sweep(
            jax.random.key(0), ys, N, LAM, GAM, N_TOTAL, I0,
            resample_fn="multinomial", interpret=True,
        )
    from bayesssm_tpu.models.sir import sir_sweep_pf_impl

    with pytest.raises(ValueError, match="sorted positions"):
        sir_sweep_pf_impl(N_TOTAL, I0, interpret=True)(
            ys, N, ["lam", "gamma"], None, None, "BPF", "SISAR",
            "multinomial", False,
        )


def test_apf_degenerate_observation_gives_neg_inf(ys):
    """An impossible observation drives the aux stage degenerate: the
    whole chain dies (-inf), matching core.py's aux-degeneracy contract."""
    y_bad = ys.at[2].set(1.0e7)
    ll, se = _sweep_batch(y_bad, 4, algorithm="APF")
    assert bool(jnp.isinf(ll).all()) and bool((ll < 0).all())
    assert np.allclose(np.asarray(se)[:, 3:], 0.0)


def test_deterministic_per_key(ys):
    ll1, se1 = _sweep_batch(ys, 8, key=3)
    ll2, se2 = _sweep_batch(ys, 8, key=3)
    np.testing.assert_array_equal(np.asarray(ll1), np.asarray(ll2))
    np.testing.assert_array_equal(np.asarray(se1), np.asarray(se2))


def test_masked_lanes_match_core(ys):
    """Traced per-chain num_particles (Q9) under the static 128-lane bound."""
    c = 192
    keys = jax.random.split(jax.random.key(5), c)

    def one(k, n_alive):
        return sir_bpf_sweep(
            k, ys, n_alive, LAM, GAM, N_TOTAL, I0, max_particles=N,
            interpret=True,
        )

    ll_m, _ = jax.jit(jax.vmap(one))(keys, jnp.full((c,), 64.0))
    ll_c, _ = _core_batch(ys, c, key=6, num_particles=64)
    assert bool(jnp.isfinite(ll_m).all())
    se_tol = 4.0 * float(
        np.hypot(np.std(np.asarray(ll_m)), np.std(np.asarray(ll_c)))
    ) / np.sqrt(c)
    assert abs(float(ll_m.mean() - ll_c.mean())) < se_tol


def test_degenerate_observation_gives_neg_inf(ys):
    """An impossible observation drives every lane below -1e8 => -inf
    (the reference's early-return contract, core's dead flag)."""
    y_bad = ys.at[2].set(1.0e7)
    ll, se = _sweep_batch(y_bad, 4)
    assert bool(jnp.isinf(ll).all()) and bool((ll < 0).all())
    # Estimates after the death step are zeroed like the core/reference.
    assert np.allclose(np.asarray(se)[:, 3:], 0.0)


def test_resample_variants_run(ys):
    ll, _ = _sweep_batch(ys, 8, key=9, resample_fn="systematic")
    assert bool(jnp.isfinite(ll).all())
    ll, _ = _sweep_batch(ys, 8, key=9, resample_algorithm="SISR")
    assert bool(jnp.isfinite(ll).all())
    # Multinomial has no sorted positions: the whole-sweep path raises
    # and points to the plain engine instead of silently degrading.
    with pytest.raises(ValueError, match="plain engine"):
        sir_filter_sweep(
            jax.random.key(0), ys, N, LAM, GAM, N_TOTAL, I0,
            resample_fn="multinomial", interpret=True,
        )


def test_pmmh_pf_impl_hook(ys):
    """pmmh(pf_impl=...) runs BOTH phases through the fused sweep and
    produces a posterior consistent with the generic engine's."""
    from bayesssm_tpu import default_tune_control, pmmh
    from bayesssm_tpu.models.sir import sir_sweep_pf_impl

    (init_fn, transition_fn, loglik_fn), log_priors, transform = sir_model(
        n_total=N_TOTAL, init_infected=I0
    )
    tc = default_tune_control(pilot_m=30, pilot_burn_in=10, pilot_reps=4)
    out = pmmh(
        "bootstrap_filter", np.asarray(ys), 40,
        init_fn, transition_fn, loglik_fn, log_priors,
        pilot_init_params=[{"lam": 0.5, "gamma": 0.3}] * 2,
        burn_in=10, num_chains=2, param_transform=transform, seed=11,
        tune_control=tc, print_summary=False,
        pf_impl=sir_sweep_pf_impl(N_TOTAL, I0, interpret=True),
    )
    s = out.summary()
    assert np.isfinite([s[p]["mean"] for p in ("lam", "gamma")]).all()
    assert 0.0 < s["lam"]["mean"] < 2.0
    assert 0.0 < s["gamma"]["mean"] < 2.0


def test_pf_impl_factory_validation(ys):
    from bayesssm_tpu.models.sir import sir_sweep_pf_impl

    factory = sir_sweep_pf_impl(N_TOTAL, I0, interpret=True)
    kw = dict(
        y=ys, num_particles=N, param_names=["lam", "gamma"],
        model_fns=None, obs_times=None, algorithm="BPF",
        resample_algorithm="SISAR", resample_fn="stratified",
        carry_weights=False,
    )
    factory(**kw)  # valid config builds
    factory(**{**kw, "algorithm": "APF"})   # every filter variant builds
    factory(**{**kw, "algorithm": "RMPF"})
    with pytest.raises(ValueError, match="BPF, APF or RMPF"):
        factory(**{**kw, "algorithm": "SIS"})
    # obs_times are supported since round 5 (builder gap loop), with the
    # portable core's validation contract.
    with pytest.raises(ValueError, match="one entry per observation"):
        factory(**{**kw, "obs_times": [1, 3]})
    with pytest.raises(ValueError, match="fresh-weight"):
        factory(**{**kw, "carry_weights": True})
    with pytest.raises(ValueError, match="lam"):
        factory(**{**kw, "param_names": ["a", "b"]})


def test_validation_errors(ys):
    with pytest.raises(ValueError, match="SIS, SISR or SISAR"):
        sir_bpf_sweep(jax.random.key(0), ys, N, LAM, GAM, N_TOTAL, I0,
                      resample_algorithm="bogus", interpret=True)
    with pytest.raises(ValueError, match="power of two"):
        sir_bpf_sweep(jax.random.key(0), ys, 100, LAM, GAM, N_TOTAL, I0,
                      interpret=True)
    with pytest.raises(ValueError, match="power of two"):
        sir_bpf_sweep(jax.random.key(0), ys, 384, LAM, GAM, N_TOTAL, I0,
                      interpret=True)
    with pytest.raises(ValueError, match="resample_fn"):
        sir_bpf_sweep(jax.random.key(0), ys, N, LAM, GAM, N_TOTAL, I0,
                      resample_fn="bogus", interpret=True)


def test_large_population_unpacked_route(ys):
    """n_total above the (S, I) packing bound (4094) routes raw
    two-column selection instead of raising (a round-5 capability the
    bespoke kernel rejected)."""
    keys = jax.random.split(jax.random.key(41), 4)
    ll, _ = jax.jit(jax.vmap(
        lambda k: sir_filter_sweep(
            k, ys, N, LAM, GAM, 5000, I0, interpret=True
        )
    ))(keys)
    assert bool(jnp.isfinite(ll).all())


def test_pmmh_pf_impl_with_chain_mesh(ys):
    # pf_impl + mesh: phases must run inside shard_map (Pallas kernels have
    # no SPMD partitioning rules), keeping each shard's kernel local.
    import warnings

    from bayesssm_tpu.models.sir import sir_model, sir_sweep_pf_impl
    from bayesssm_tpu.parallel.mesh import make_chain_mesh
    from bayesssm_tpu.pmmh.driver import pmmh
    from bayesssm_tpu.pmmh.tuning import default_tune_control

    fns, log_priors, transform = sir_model(n_total=N_TOTAL, init_infected=I0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out = pmmh(
            "bootstrap_filter", ys, 8, fns[0], fns[1], fns[2], log_priors,
            pilot_init_params={"lam": 0.5, "gamma": 0.2}, burn_in=2,
            num_chains=8, seed=2, param_transform=transform,
            tune_control=default_tune_control(
                pilot_m=10, pilot_burn_in=2, pilot_reps=2
            ),
            mesh=make_chain_mesh(8), print_summary=False,
            pf_impl=sir_sweep_pf_impl(N_TOTAL, I0, interpret=True),
        )
    for p, chain in out.theta_chain.items():
        assert chain.shape == (8, 6), (p, chain.shape)
        assert np.isfinite(chain).all(), p
