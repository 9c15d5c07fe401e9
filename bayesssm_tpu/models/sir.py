"""Stochastic SIR epidemic model — the vignette parity/benchmark model.

Re-expresses the reference's per-particle Gillespie event loop
(/root/reference/vignettes/articles/stochastic-sir-model.Rmd:152-176) as a
fully vectorized exact simulation: one ``lax.while_loop`` advances ALL
particles' continuous-time Markov chains simultaneously, with per-lane
active masks; the loop exits when every lane has passed the unit time
horizon. This keeps the exact jump-process distribution (unlike
tau-leaping) while remaining a single SIMD program over
``[num_particles, 2]`` states — the hardest model-side rewrite flagged in
SURVEY.md §7.

Model: closed population of ``n_total``; latent state (S, I); infection
rate lambda/n_total * S * I, removal rate gamma * I; observation
``Y_t ~ Pois(I(t))`` at integer times. Priors lambda ~ HalfNormal(1),
gamma ~ HalfNormal(2), both log-transformed (vignette:264-333).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from bayesssm_tpu.models.distributions import halfnorm_logpdf, pois_logpmf

__all__ = [
    "sir_model",
    "simulate_sir",
    "gillespie_step",
    "tau_leap_step",
    "sir_sweep_pf_impl",
    "sir_builder_pf_impl",
    "sir_aux_log_likelihood_fn",
    "sir_move_fn",
]

# Hard cap on Gillespie events per unit interval; with rates bounded by
# (lambda/4) n + gamma n the true event count is far below this for the
# benchmark population sizes.
MAX_EVENTS = 100_000


def gillespie_step(key, state, lam, gamma, n_total, t_end=1.0, unroll=4):
    """Advance all particles' (S, I) by one unit of continuous time.

    ``state``: float [n, 2]. Exact stochastic simulation; all lanes advance
    in lock-step with masking, so the compiled loop runs
    max-events-over-lanes / unroll iterations. Each ``while_loop``
    iteration draws one combined random block and applies ``unroll``
    events back-to-back in registers — amortizing the PRNG and the
    loop-condition reduction over several events without changing the
    sampled jump-process distribution.
    """
    s = state[..., 0]
    i = state[..., 1]
    t = jnp.zeros_like(s)
    active = i > 0

    # The loop draws from the caller's key as it is (threefry on the
    # default key type): threefry is fused integer arithmetic on the GPU,
    # and re-keying the loop onto impl="rbg" measured about twice as slow
    # in this loop on an H100 (PERF.md).

    def cond(carry):
        _, _, _, _, active, steps = carry
        return jnp.logical_and(jnp.any(active), steps < MAX_EVENTS)

    def body(carry):
        key, s, i, t, active, steps = carry
        key, k_r = jax.random.split(key)
        # One fused draw per iteration: [2, unroll, ...] uniforms feed the
        # waiting times (via inverse CDF) and the event choices. The log1p
        # for the whole unroll block runs as one vector pass, and the event
        # choice compares r * rate_tot < rate_inf rather than dividing —
        # one transcendental + one divide per event is all that remains.
        r = jax.random.uniform(k_r, (2, unroll) + s.shape)
        neglog = -jnp.log1p(-r[0])
        for e in range(unroll):
            rate_inf = (lam / n_total) * s * i
            rate_tot = rate_inf + gamma * i
            # rate_tot == 0 gives dt = +inf (neglog > 0 always), so the
            # lane fails the horizon check and deactivates — no NaN and no
            # guard select needed. Inactive lanes' t may run past t_end;
            # only `active` gates every state update, so that is harmless.
            dt = neglog[e] / rate_tot
            t = t + dt
            fire = jnp.logical_and(active, t <= t_end)
            infect = r[1, e] * rate_tot < rate_inf
            s = jnp.where(fire & infect, s - 1.0, s)
            i = jnp.where(fire, jnp.where(infect, i + 1.0, i - 1.0), i)
            active = fire & (i > 0)
        return key, s, i, t, active, steps + unroll

    _, s, i, _, _, _ = jax.lax.while_loop(
        cond, body, (key, s, i, t, active, jnp.zeros((), jnp.int32))
    )
    return jnp.stack([s, i], axis=-1)


def tau_leap_step(key, state, lam, gamma, n_total, substeps: int = 10):
    """Approximate SIR day-step by binomial tau-leaping.

    Fixed-cost alternative to the exact ``gillespie_step``: the unit
    interval is divided into ``substeps`` leaps; infections per leap are
    Binomial(S, 1 - exp(-lam I / n dt)) and removals Binomial(I,
    1 - exp(-gamma dt)). No data-dependent loop, so all lanes cost the
    same, at the price of a discretization bias that vanishes as substeps grows.
    """
    dt = 1.0 / substeps

    def body(carry, k):
        s, i = carry
        k1, k2 = jax.random.split(k)
        p_inf = -jnp.expm1(-(lam / n_total) * i * dt)
        p_rem = -jnp.expm1(-gamma * dt)
        n_inf = jax.random.binomial(k1, s, p_inf)
        n_rem = jax.random.binomial(k2, i, p_rem)
        s = s - n_inf
        i = jnp.maximum(i + n_inf - n_rem, 0.0)
        return (s, i), None

    keys = jax.random.split(key, substeps)
    (s, i), _ = jax.lax.scan(body, (state[..., 0], state[..., 1]), keys)
    return jnp.stack([s, i], axis=-1)


def sir_model(
    n_total: int = 500,
    init_infected: int = 70,
    transition: str = "gillespie",
    substeps: int = 10,
):
    """Return (model_fns, log_priors, param_transform) for the SIR model.

    Mirrors the vignette's init/transition/likelihood functions
    (stochastic-sir-model.Rmd:283-310): all particles start at the known
    initial state, the transition is one unit of exact Gillespie dynamics,
    and the likelihood is Poisson in the infectious count.

    ``transition`` selects the day-step simulator:
      * ``"gillespie"`` — exact jump process as a masked XLA ``while_loop``.
        The whole-sweep kernel (``sir_sweep_pf_impl``) runs the same
        process with per-chain termination.
      * ``"tauleap"`` — approximate binomial tau-leaping (fixed cost).
    """
    if transition not in ("gillespie", "tauleap"):
        raise ValueError("transition must be 'gillespie' or 'tauleap'")
    s0 = float(n_total - init_infected)
    i0 = float(init_infected)

    def init_fn(key, num_particles):
        return jnp.tile(
            jnp.array([s0, i0], dtype=jnp.float32), (num_particles, 1)
        )

    if transition == "gillespie":
        def transition_fn(key, particles, lam, gamma):
            return gillespie_step(key, particles, lam, gamma, float(n_total))
    else:
        def transition_fn(key, particles, lam, gamma):
            return tau_leap_step(
                key, particles, lam, gamma, float(n_total), substeps
            )

    def log_likelihood_fn(y, particles):
        return pois_logpmf(y, particles[..., 1])

    log_priors = {
        "lam": lambda v: halfnorm_logpdf(v, 1.0),
        "gamma": lambda v: halfnorm_logpdf(v, 2.0),
    }
    param_transform = {"lam": "log", "gamma": "log"}
    return (init_fn, transition_fn, log_likelihood_fn), log_priors, param_transform


def sir_builder_pf_impl(
    n_total: int = 500,
    init_infected: int = 70,
    unroll: int = 8,
    move_step_max: int = 2,
    interpret: bool = False,
    pack: bool = True,
):
    """PMMH ``pf_impl`` factory routing the SIR filter through the
    whole-sweep kernel — a sweep-builder instance over
    ``ops/sir_sweep_pallas.py::sir_sweep_parts`` (exact Gillespie day in
    a callback while_loop, Poisson weights with a precomputed
    ``lgamma(y+1)`` observation column, packed (S, I) selection, APF
    lookahead, RMPF move).

    Usage: ``pmmh(..., pf_impl=sir_builder_pf_impl(500, 70))``. Shares
    ``pmmh.tuning._make_pf_loglike``'s signature so the driver can swap
    it in for BOTH the pilot-tuning and sampling phases — the
    analogue of the reference's Rcpp escape hatch
    (/root/reference/vignettes/articles/detailed-overview.Rmd:401-470).
    Supports BPF, APF, RMPF with fresh-weight SISR/SISAR,
    stratified/systematic resampling, and irregular ``obs_times``
    (the builder's static gap loop); anything else raises so misuse
    cannot silently change the sampled distribution.
    """
    from bayesssm_tpu.ops.sir_sweep_pallas import sir_sweep_parts
    from bayesssm_tpu.ops.sweep_builder import build_sweep_pf_impl

    parts = sir_sweep_parts(
        n_total, init_infected, unroll=unroll,
        move_step_max=move_step_max, pack=pack,
    )
    return build_sweep_pf_impl(
        2, parts["init_fn"], parts["transition_fn"],
        parts["log_weight_fn"], ("lam", "gamma"),
        aux_log_weight_fn=parts["aux_log_weight_fn"],
        move_fn=parts["move_fn"],
        interpret=interpret,
        num_obs_cols=2,
        obs_transform=parts["obs_transform"],
        **parts["pack_kw"],
    )


# Both names build the same builder-backed pf_impl.
sir_sweep_pf_impl = sir_builder_pf_impl


def sir_aux_log_likelihood_fn(y, particles):
    """APF lookahead weights for the SIR model (BASELINE.json config 4).

    The reference's APF evaluates the auxiliary weights on particles the
    gap loop has ALREADY propagated to time t (quirk Q2,
    /root/reference/R/particle_filter_core.R:139-175), so the natural
    lookahead is the observation density at the propagated infectious
    count — the same Poisson term as the weight function, which makes the
    auxiliary resample a one-step-ahead adapted proposal.
    """
    return pois_logpmf(y, particles[..., 1])


def sir_move_fn(n_total: int = 500, step_max: int = 2):
    """RMPF rejuvenation move for SIR (BASELINE.json config 5).

    A random-walk Metropolis move on the infectious count holding S fixed:
    propose I' = I + U{-step_max..step_max} and accept with the Poisson
    observation-likelihood ratio, rejecting proposals outside
    [0, n_total - S] (rejection — not clipping — keeps the uniform
    proposal symmetric, so the move is invariant for the observation
    conditional). The vectorized analogue of the reference's per-particle
    move contract (/root/reference/R/particle_filter_core.R:226-234; move
    semantics as in Gilks & Berzuini 2001), rejuvenating duplicate
    particles after the forced SISR resample.
    """

    def move_fn(key, particles, y, lam, gamma):
        del lam, gamma  # the observation conditional is theta-free
        s = particles[..., 0]
        i = particles[..., 1]
        k_step, k_acc = jax.random.split(key)
        step = jax.random.randint(
            k_step, i.shape, -step_max, step_max + 1
        ).astype(i.dtype)
        i_prop = i + step
        in_support = (i_prop >= 0.0) & (i_prop <= float(n_total) - s)
        log_ratio = pois_logpmf(y, jnp.maximum(i_prop, 0.0)) - pois_logpmf(
            y, i
        )
        u = jax.random.uniform(k_acc, i.shape)
        accept = in_support & (jnp.log(u) < log_ratio)
        i_new = jnp.where(accept, i_prop, i)
        return jnp.stack([s, i_new], axis=-1)

    return move_fn


def simulate_sir(
    seed=1405,
    n_total=500,
    init_infected=70,
    t_max=10,
    lam=0.5,
    gamma=0.2,
):
    """Host-side exact simulation of one epidemic + Poisson observations.

    Returns (states [t_max, 2], y [t_max]) like the vignette's
    simulate_epidemic (stochastic-sir-model.Rmd:178-194).
    """
    rng = np.random.default_rng(seed)
    s = float(n_total - init_infected)
    i = float(init_infected)
    states = np.zeros((t_max, 2))
    for t in range(t_max):
        tt = 0.0
        while i > 0:
            rate_inf = lam / n_total * s * i
            rate_rem = gamma * i
            rate_tot = rate_inf + rate_rem
            if rate_tot <= 0:
                break
            dt = rng.exponential(1.0 / rate_tot)
            if tt + dt > 1.0:
                break
            tt += dt
            if rng.uniform() < rate_inf / rate_tot:
                s -= 1.0
                i += 1.0
            else:
                i -= 1.0
        states[t] = (s, i)
    y = rng.poisson(states[:, 1])
    return states, y.astype(np.float64)
