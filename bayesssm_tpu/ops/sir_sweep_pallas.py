"""Whole-sweep SIR filter — a sweep-builder instance (BPF/APF/RMPF).

The ENTIRE T-observation SIR particle filter in one Triton kernel
(ops/sweep_builder.py): exact Gillespie day in an event ``while_loop``
that each block of chains leaves at its own event count, Poisson weights
with a host-precomputed ``lgamma(y+1)`` observation column, and packed
(S, I) selection. This module holds the SIR-specific callbacks
(:func:`sir_sweep_parts`) and the public entry points; every scaffold
concern — resampling, masked lanes (Q9), degenerate -inf contract, APF
aux recompute + Q2 double transition
(/root/reference/R/particle_filter_core.R:139-175), RMPF forced SISR +
move (/root/reference/R/resample_move_filter.R:190-236), the in-kernel
random stream, chain blocking — lives in the builder.

Constraints: ``resample_fn`` must be stratified or systematic (sorted
positions), and ``max_particles`` a power of two (Triton block width;
pmmh() pads tuned counts to one). ``n_total`` above the packing bound
4094 rides the selection as two raw f32 columns instead of one packed
value.

Semantics are the reference filters with fresh-weight SISR/SISAR
(/root/reference/R/particle_filter_core.R:123-246, quirks Q2/Q4/Q5 as in
filters/core.py's default ``carry_weights=False``). Bit-streams differ
from the plain engine — parity is distributional, like every RNG-bearing
path (tests/test_sir_sweep.py, tests/test_sir_builder.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["sir_filter_sweep", "sir_bpf_sweep", "sir_sweep_parts"]

# (S, I) packing base: both counts are integers <= n_total <= _PACK - 2,
# so v = S*_PACK + I < 2^24 is exact in f32 and v/_PACK is an exact
# exponent shift (power of two), making floor-unpack exact.
_PACK = 4096.0


def sir_sweep_parts(
    n_total: int,
    init_infected: int,
    unroll: int = 8,
    move_step_max: int = 2,
    pack: bool = True,
):
    """The SIR model as sweep-builder callbacks.

    Returns a dict with ``init_fn``/``transition_fn``/``log_weight_fn``/
    ``aux_log_weight_fn``/``move_fn`` (the builder's callback
    contract), ``obs_transform`` (appends host-precomputed
    ``lgamma(y+1)`` as a second observation column), ``num_obs_cols``,
    and ``pack_kw`` (packed (S, I) selection when ``n_total`` fits the
    exact-f32 bound).

    The transition is one exact Gillespie day: an event ``while_loop``
    drawing ``2*unroll`` uniform blocks per iteration with the RNG
    counter threaded through the loop carry (SweepRng contract). Event
    arithmetic is trimmed to ONE division per event: for any live lane
    i >= 1 and gamma > 0, rate_tot >= gamma > 0; dead lanes' inf/NaN are
    gated behind ``fire`` (IEEE: NaN compares false). The branch
    decision uses ``u * rate_tot < rate_inf`` (multiply) instead of a
    second division.
    """
    from bayesssm_tpu.models.sir import MAX_EVENTS

    nt = float(n_total)
    s0 = float(n_total - init_infected)
    i0 = float(init_infected)
    neg = np.float32(-1e30)
    unroll = int(unroll)
    move_step_max = int(move_step_max)

    def init_fn(rng, theta):
        like = theta[0]
        return (
            jnp.full_like(like, np.float32(s0)),
            jnp.full_like(like, np.float32(i0)),
        )

    def transition_fn(rng, cols, theta, t):
        s, i = cols
        lam, gam = theta
        lam_n = lam * np.float32(1.0 / nt)
        tloc = jnp.zeros_like(s)
        active = (i > 0.0).astype(jnp.float32)

        def cond(carry):
            _, _, _, act, steps, _ = carry
            return jnp.logical_and(jnp.max(act) > 0.0, steps < MAX_EVENTS)

        def body(carry):
            s, i, tloc, active, steps, ctr = carry
            u, ctr = rng.raw_uniform_blocks(2 * unroll, ctr)
            for e in range(unroll):
                rate_inf = lam_n * s * i
                rate_tot = rate_inf + gam * i
                dt = -jnp.log1p(-u[2 * e]) * (1.0 / rate_tot)
                t_new = tloc + dt
                fire = jnp.logical_and(active > 0.0, t_new <= 1.0)
                infect = u[2 * e + 1] * rate_tot < rate_inf
                s = jnp.where(jnp.logical_and(fire, infect), s - 1.0, s)
                i = jnp.where(
                    fire, jnp.where(infect, i + 1.0, i - 1.0), i
                )
                tloc = jnp.where(fire, t_new, tloc)
                active = jnp.logical_and(fire, i > 0.0).astype(
                    jnp.float32
                )
            return s, i, tloc, active, steps + unroll, ctr

        s, i, _, _, _, ctr_out = jax.lax.while_loop(
            cond, body,
            (s, i, tloc, active, jnp.zeros((), jnp.int32), rng.counter()),
        )
        rng.set_counter(ctr_out)
        return (s, i)

    def _pois_lw(i, y_v, lgy):
        """Poisson log-pmf in the infectious count
        (models/distributions.pois_logpmf), i = 0 handled exactly."""
        safe_i = jnp.where(i > 0.0, i, 1.0)
        lw = y_v * jnp.log(safe_i) - i - lgy
        return jnp.where(
            i > 0.0, lw, jnp.where(y_v == 0.0, 0.0, neg)
        )

    def log_weight_fn(cols, theta, y_t):
        y_v, lgy = y_t
        return _pois_lw(cols[1], y_v, lgy)

    # APF lookahead = the observation density at the propagated
    # infectious count (quirk Q2 timing; models/sir.py::
    # sir_aux_log_likelihood_fn is the portable twin).
    aux_log_weight_fn = log_weight_fn

    def move_fn(rng, cols, theta, y_t):
        """RMPF rejuvenation (models/sir.py::sir_move_fn's in-kernel
        twin): I' = I + U{-k..k}, accepted with the Poisson
        observation-likelihood ratio, rejected outside
        [0, n_total - S]."""
        y_v, lgy = y_t
        s, i = cols
        u = rng.uniforms(2)
        span = np.float32(2 * move_step_max + 1)
        step = jnp.floor(u[0] * span) - np.float32(move_step_max)
        i_prop = i + step
        in_support = jnp.logical_and(
            i_prop >= 0.0, i_prop <= np.float32(nt) - s
        )
        log_ratio = _pois_lw(
            jnp.maximum(i_prop, 0.0), y_v, lgy
        ) - _pois_lw(i, y_v, lgy)
        accept = jnp.logical_and(in_support, jnp.log(u[1]) < log_ratio)
        return (s, jnp.where(accept, i_prop, i))

    if pack and float(n_total) <= _PACK - 2.0:
        pack = np.float32(_PACK)

        def pack_fn(cols):
            return (cols[0] * pack + cols[1],)

        def unpack_fn(packed):
            v = packed[0]
            s = jnp.floor(v * np.float32(1.0 / _PACK))
            return (s, v - s * pack)

        pack_kw = dict(
            pack_fn=pack_fn, unpack_fn=unpack_fn, num_packed_cols=1
        )
    else:
        pack_kw = {}

    def obs_transform(ys):
        from jax.scipy.special import gammaln

        ys = jnp.asarray(ys, jnp.float32).reshape(-1)
        return jnp.stack([ys, gammaln(ys + 1.0)], axis=1)

    return dict(
        init_fn=init_fn,
        transition_fn=transition_fn,
        log_weight_fn=log_weight_fn,
        aux_log_weight_fn=aux_log_weight_fn,
        move_fn=move_fn,
        obs_transform=obs_transform,
        num_obs_cols=2,
        pack_kw=pack_kw,
    )


@functools.lru_cache(maxsize=None)
def _sir_op(n_total, init_infected, unroll, method, always_resample,
            never_resample, algorithm, move_step_max, interpret):
    from bayesssm_tpu.ops.sweep_builder import build_sweep_op

    parts = sir_sweep_parts(
        n_total, init_infected, unroll=unroll,
        move_step_max=move_step_max,
    )
    return build_sweep_op(
        2, parts["init_fn"], parts["transition_fn"],
        parts["log_weight_fn"], 2,
        aux_log_weight_fn=(
            parts["aux_log_weight_fn"] if algorithm == "APF" else None
        ),
        move_fn=parts["move_fn"] if algorithm == "RMPF" else None,
        resample_fn=method, always_resample=always_resample,
        never_resample=never_resample,
        interpret=interpret, num_obs_cols=2,
        **parts["pack_kw"],
    )


def sir_filter_sweep(
    key,
    y,
    num_particles,
    lam,
    gamma,
    n_total,
    init_infected,
    algorithm: str = "BPF",
    max_particles: int | None = None,
    resample_fn: str = "stratified",
    resample_algorithm: str = "SISAR",
    threshold=None,
    unroll: int = 8,
    move_step_max: int = 2,
    interpret: bool = False,
):
    """Full SIR particle-filter sweep in one Triton kernel (vmap-aware).

    Drop-in fast path for the PMMH hot loop on the SIR model: returns
    ``(loglike, state_est [T+1, 2])`` with the same sampling distribution
    as ``bootstrap_filter`` / ``auxiliary_filter`` / ``resample_move_filter``
    over ``sir_model(...)`` under the default fresh-weight semantics
    (bit-streams differ — parity is distributional, like every RNG-bearing
    path). ``num_particles`` may be a traced per-chain count with
    ``max_particles`` the static lane bound (a power of two). RMPF forces
    SISR (filters/resample_move.py:34-39 mirroring
    /root/reference/R/resample_move_filter.R:213-230).

    ``resample_fn`` must be stratified or systematic (module
    docstring).
    """
    if algorithm not in ("BPF", "APF", "RMPF"):
        raise ValueError("algorithm must be one of ('BPF', 'APF', 'RMPF')")
    if resample_algorithm not in ("SIS", "SISR", "SISAR"):
        raise ValueError(
            "sir_filter_sweep supports SIS, SISR or SISAR"
        )
    if resample_fn not in ("stratified", "systematic", "multinomial"):
        raise ValueError(f"unknown resample_fn {resample_fn!r}")
    if resample_fn == "multinomial":
        raise ValueError(
            "the whole-sweep path resamples by a search over sorted "
            "positions (stratified/systematic); multinomial resampling "
            "runs on the plain engine (filters/core.py)"
        )
    if max_particles is None:
        max_particles = int(num_particles)

    op = _sir_op(
        int(n_total), int(init_infected), int(unroll), resample_fn,
        algorithm == "RMPF" or resample_algorithm == "SISR",
        resample_algorithm == "SIS" and algorithm != "RMPF",
        algorithm, int(move_step_max), bool(interpret),
    )
    from jax.scipy.special import gammaln

    ys = jnp.asarray(y, jnp.float32).reshape(-1)
    y2 = jnp.stack([ys, gammaln(ys + 1.0)], axis=1)   # [T, 2] obs rows
    theta_vec = jnp.stack([
        jnp.asarray(lam, jnp.float32).reshape(()),
        jnp.asarray(gamma, jnp.float32).reshape(()),
    ])
    return op(
        key, y2, theta_vec, num_particles,
        max_particles=int(max_particles), threshold=threshold,
    )


def sir_bpf_sweep(key, y, num_particles, lam, gamma, n_total, init_infected,
                  **kw):
    """Bootstrap-filter specialization of :func:`sir_filter_sweep`."""
    return sir_filter_sweep(
        key, y, num_particles, lam, gamma, n_total, init_infected,
        algorithm="BPF", **kw,
    )
