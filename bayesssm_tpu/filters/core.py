"""The single SMC engine shared by all particle filters.

Re-design of /root/reference/R/particle_filter_core.R:19-267 for JAX.
The reference's per-observation ``for`` loop becomes a ``lax.scan``; its
data-dependent branches (adaptive resampling, degenerate-weight early exit)
become branchless ``where``/``select`` so one compiled program serves every
trajectory, and the whole filter batches under ``vmap`` over a leading
chains axis.

Semantics intentionally reproduced from the reference (see SURVEY.md §5
quirks):
  * Q2 — the APF branch propagates in the gap loop AND again after
    auxiliary resampling (:124-136 vs :159).
  * Q3 — ``loglike_history`` is the cumulative log-likelihood (:208-209).
  * Q4 — ESS at t=0 is reported as ``num_particles``; after a resample the
    recorded ESS is overwritten with ``num_particles`` (:106-107, :220-223).
  * Q5 — state estimates after resampling use the reset uniform weights.
  * Weights are computed fresh from the current observation each step — the
    reference never carries un-resampled weights forward (:176-183), which
    makes SIS/SISAR likelihood estimators biased (under SISR the two
    formulations coincide). Replicated by default for parity;
    ``carry_weights=True`` enables the textbook-correct accumulation
    ``incr_t = log sum_i W_{t-1,i} exp(lw_t,i)`` that keeps the estimator
    unbiased under adaptive resampling.
  * Degenerate weights (all log-weights < -1e8, :189-202) set the final
    log-likelihood to -inf. The reference early-returns instead; here the
    dead flag propagates branchlessly and later history entries are zeroed.

Masked particles: ``num_particles`` may be a traced scalar bounded by the
static ``max_particles`` — lanes at index >= num_particles carry -inf
log-weight and are never selected as ancestors. This is how PMMH preserves
the reference's per-chain tuned particle counts (Q9) under one static shape.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from bayesssm_tpu.ops.resampling import (
    RESAMPLE_METHODS,
    gather_particles,
    resample_indices,
    sharded_gather,
    sharded_resample_indices,
)
from bayesssm_tpu.ops.weights import (
    DEGENERATE_LOG_WEIGHT,
    effective_sample_size,
    normalize_log_weights,
)
from bayesssm_tpu.utils.signatures import adapt_fn, adapt_move_fn

__all__ = ["particle_filter_core", "FilterResult", "FilterConfig"]

ALGORITHMS = ("BPF", "APF", "RMPF")
RESAMPLE_ALGORITHMS = ("SIS", "SISR", "SISAR")


@dataclasses.dataclass(frozen=True)
class FilterConfig:
    """Typed filter configuration (SURVEY.md §5 config row).

    The reference configures its core through ``match.arg`` enum arguments
    (/root/reference/R/particle_filter_core.R:33-50); this is the validated
    dataclass equivalent — the filter analogue of ``TuneControl``. Pass it
    as ``particle_filter_core(..., config=cfg)``; it then supplies every
    field below and the corresponding individual keyword arguments are
    ignored. Field names/defaults mirror ``particle_filter_core``.
    """

    algorithm: str = "BPF"
    resample_algorithm: str = "SISAR"
    resample_fn: str = "stratified"
    threshold: Optional[float] = None
    return_particles: bool = True
    max_particles: Optional[int] = None
    carry_weights: bool = False
    particle_axis: Optional[str] = None
    particle_axis_size: int = 1

    def __post_init__(self):
        if self.algorithm not in ALGORITHMS:
            raise ValueError(f"algorithm must be one of {ALGORITHMS}")
        if self.resample_algorithm not in RESAMPLE_ALGORITHMS:
            raise ValueError(
                f"resample_algorithm must be one of {RESAMPLE_ALGORITHMS}"
            )
        if self.resample_fn not in RESAMPLE_METHODS:
            raise ValueError(f"resample_fn must be one of {RESAMPLE_METHODS}")
        if self.threshold is not None and not self.threshold >= 0:
            raise ValueError("threshold must be non-negative")
        if self.max_particles is not None and self.max_particles < 1:
            raise ValueError("max_particles must be a positive integer")
        if self.particle_axis_size < 1:
            raise ValueError("particle_axis_size must be >= 1")

    def kwargs(self) -> dict:
        """The fields as ``particle_filter_core`` keyword arguments."""
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class FilterResult:
    """Mirror of the reference filter's return list
    (/root/reference/R/particle_filter_core.R:248-266).

    A registered JAX pytree: the array fields are leaves (so results flow
    through vmap/jit/scan) and the algorithm labels are static metadata.
    """

    state_est: jnp.ndarray          # [T+1, d] (or [T+1] for 1-D states)
    ess: jnp.ndarray                # [T+1]
    loglike: jnp.ndarray            # scalar
    loglike_history: jnp.ndarray    # [T], cumulative (Q3)
    algorithm: str = "BPF"
    resample_algorithm: str = "SISAR"
    particles_history: Optional[jnp.ndarray] = None  # [T+1, n, d] / [T+1, n]
    weights_history: Optional[jnp.ndarray] = None    # [T+1, n]


jax.tree_util.register_dataclass(
    FilterResult,
    data_fields=[
        "state_est",
        "ess",
        "loglike",
        "loglike_history",
        "particles_history",
        "weights_history",
    ],
    meta_fields=["algorithm", "resample_algorithm"],
)


def _resolve_obs_times(obs_times, num_obs: int) -> np.ndarray:
    """Validate observation times (the reference's checkmate assertions,
    /root/reference/R/particle_filter_core.R:55-60 /
    tests/testthat/test-bootstrap_filter.R:73-112)."""
    if obs_times is None:
        return np.arange(1, num_obs + 1, dtype=np.int64)
    try:
        ot_raw = np.asarray(obs_times)
        if not np.issubdtype(ot_raw.dtype, np.number):
            raise TypeError
    except (TypeError, ValueError):
        raise ValueError("obs_times must be numeric integers") from None
    if not np.all(ot_raw == np.floor(ot_raw)):
        # The reference rejects fractional times; a silent int cast here
        # would change which transitions the gap loop runs.
        raise ValueError("obs_times must be integers")
    ot = ot_raw.astype(np.int64)
    if ot.ndim != 1 or ot.shape[0] != num_obs:
        raise ValueError("obs_times must have one entry per observation")
    if (ot < 1).any() or (np.diff(ot) <= 0).any():
        raise ValueError("obs_times must be >= 1 and strictly increasing")
    return ot


def obs_times_to_gaps(obs_times, num_obs: int) -> tuple:
    """Static per-observation transition counts from observation times
    (validated with the reference contract): ``gaps[i] = ot[i] - ot[i-1]``
    with an implicit ``ot[-1] = 0`` — the whole-sweep kernel's compiled
    form of the gap-propagation loop
    (/root/reference/R/particle_filter_core.R:122-137)."""
    ot = _resolve_obs_times(obs_times, num_obs)
    return tuple(np.diff(ot, prepend=0).tolist())


def particle_filter_core(
    key: jax.Array,
    y,
    num_particles,
    init_fn,
    transition_fn,
    weight_fn,
    aux_weight_fn=None,
    move_fn=None,
    theta: Optional[dict] = None,
    obs_times=None,
    algorithm: str = "BPF",
    resample_algorithm: str = "SISAR",
    resample_fn: str = "stratified",
    threshold: Optional[float] = None,
    return_particles: bool = True,
    max_particles: Optional[int] = None,
    carry_weights: bool = False,
    particle_axis: Optional[str] = None,
    particle_axis_size: int = 1,
    config: Optional["FilterConfig"] = None,
):
    """Run one particle filter. See module docstring for semantics.

    Args:
      key: PRNG key; all randomness (model simulation and resampling) derives
        from it, giving bit-exact reproducibility for a fixed key.
      y: observations, ``[T]`` or ``[T, d_y]``.
      num_particles: particle count. Either a static int, or a traced scalar
        (masked mode, requires ``max_particles``).
      init_fn / transition_fn / weight_fn / aux_weight_fn / move_fn: model
        functions (see ssm.py for the calling convention). ``weight_fn`` is
        the observation log-density, as in the reference core.
      theta: dict of named model parameters forwarded to the model functions.
      obs_times: optional concrete integer observation times (>= 1, strictly
        increasing); gaps are bridged with extra transitions
        (/root/reference/R/particle_filter_core.R:122-137).
      algorithm: BPF | APF | RMPF.
      resample_algorithm: SIS | SISR | SISAR (RMPF forces SISR).
      resample_fn: stratified | systematic | multinomial.
      threshold: SISAR ESS threshold (default num_particles / 2).
      return_particles: include particle/weight histories in the result.
      max_particles: static lane count when ``num_particles`` is traced.
      carry_weights: textbook weight accumulation (see module docstring).
      particle_axis: optional mesh axis name the PARTICLE dimension is
        sharded over. The core must then run inside ``shard_map``;
        ``num_particles``/``max_particles`` stay GLOBAL counts while every
        particle array carries the ``num_particles / particle_axis_size``
        local slice. Weight normalization/ESS complete over ``pmax``/
        ``psum`` and resampling goes through
        ``ops.resampling.sharded_resample_indices`` (shard-identical
        stratum draws + one ``all_gather``), so the likelihood estimator is
        exactly the unsharded telescoping product. Model-randomness keys
        are decorrelated per shard via ``fold_in(key, shard_index)``;
        resampling keys stay shard-identical. This is ONE engine serving
        both layouts — the former separate sharded filter
        (parallel/sharded.py) now wraps this path.
      particle_axis_size: static size of ``particle_axis`` (required when
        ``particle_axis`` is set; mesh sizes are not recoverable statically
        inside the trace).
      config: optional ``FilterConfig``; when given it supplies every
        filter-shape option above (algorithm, resample_*, threshold,
        return_particles, max_particles, carry_weights,
        particle_axis*) and the corresponding keyword arguments are ignored.
    """
    if config is not None:
        cfg = config.kwargs()
        algorithm = cfg["algorithm"]
        resample_algorithm = cfg["resample_algorithm"]
        resample_fn = cfg["resample_fn"]
        threshold = cfg["threshold"]
        return_particles = cfg["return_particles"]
        max_particles = cfg["max_particles"]
        carry_weights = cfg["carry_weights"]
        particle_axis = cfg["particle_axis"]
        particle_axis_size = cfg["particle_axis_size"]
    if algorithm not in ALGORITHMS:
        raise ValueError(f"algorithm must be one of {ALGORITHMS}")
    if resample_algorithm not in RESAMPLE_ALGORITHMS:
        raise ValueError(f"resample_algorithm must be one of {RESAMPLE_ALGORITHMS}")
    if resample_fn not in RESAMPLE_METHODS:
        raise ValueError(f"resample_fn must be one of {RESAMPLE_METHODS}")
    if algorithm == "APF" and aux_weight_fn is None:
        raise ValueError("APF requires aux_weight_fn")
    if algorithm == "RMPF" and move_fn is None:
        raise ValueError("RMPF requires a move_fn")

    theta = dict(theta or {})

    if max_particles is None:
        if not isinstance(num_particles, (int, np.integer)):
            raise ValueError(
                "max_particles is required when num_particles is traced"
            )
        if num_particles < 1:
            raise ValueError("num_particles must be a positive integer")
        max_particles = int(num_particles)
    n_static = int(max_particles)

    sharded = particle_axis is not None
    if sharded:
        if particle_axis_size < 1 or n_static % particle_axis_size:
            raise ValueError(
                "num_particles/max_particles must be divisible by "
                "particle_axis_size"
            )
        n_loc = n_static // particle_axis_size
    else:
        n_loc = n_static

    init = adapt_fn(init_fn, "init_fn", required=("num_particles",))
    trans = adapt_fn(transition_fn, "transition_fn", required=("particles",))
    weight = adapt_fn(weight_fn, "weight_fn", required=("particles", "y"))
    auxw = (
        adapt_fn(aux_weight_fn, "aux_weight_fn", required=("particles", "y"))
        if aux_weight_fn is not None
        else None
    )
    # Reference-style single-particle move functions (declaring `particle`)
    # are auto-vmapped over the particle axis (R core calls them per
    # particle, /root/reference/R/particle_filter_core.R:226-234).
    move = adapt_move_fn(move_fn) if move_fn is not None else None

    if not isinstance(y, jax.core.Tracer):
        # assert_numeric(y), /root/reference/R/particle_filter_core.R:52.
        # Tracers (y traced through a user's jit) are numeric by
        # construction and cannot be materialized here.
        try:
            y_host = np.asarray(y)
            if not np.issubdtype(y_host.dtype, np.number):
                raise TypeError
        except (TypeError, ValueError):
            raise ValueError("y must be numeric") from None
    ys = jnp.asarray(y)
    if ys.ndim == 1:
        ys = ys[:, None]
    if ys.ndim != 2:
        raise ValueError("y must be a [T] vector or [T, d_y] matrix")
    num_obs, d_y = ys.shape
    if num_obs < 1:
        raise ValueError("y must contain at least one observation")
    ot = _resolve_obs_times(obs_times, num_obs)
    gaps = np.diff(np.concatenate([[0], ot]))
    max_gap = int(gaps.max())
    plain_gaps = bool((gaps == 1).all())

    def canon(p, who):
        # Particles keep the user's native rank: [n] for 1-D state models,
        # [n, d] otherwise (the R core's vector/matrix duality,
        # /root/reference/R/particle_filter_core.R:77-88). Under particle
        # sharding each shard holds (and user fns see) the local slice.
        p = jnp.asarray(p)
        if p.ndim == 1:
            if p.shape[0] != n_loc:
                raise ValueError(f"{who} must return num_particles")
        elif p.ndim == 2:
            if p.shape[0] != n_loc:
                raise ValueError(f"{who} must return num_particles rows")
        else:
            raise ValueError(f"{who} must return a [n] or [n, d] array")
        return p

    p_idx = lax.axis_index(particle_axis) if sharded else None

    key, k_init = jax.random.split(key)
    if sharded:
        # Decorrelate the model-simulation stream per shard; resampling
        # keys (below) stay shard-identical on purpose.
        k_init = jax.random.fold_in(k_init, p_idx)
    particles0 = canon(init(key=k_init, num_particles=n_loc, **theta), "init_fn")
    one_dim = particles0.ndim == 1
    dtype = particles0.dtype

    n_f = jnp.asarray(num_particles, dtype=dtype)
    if sharded:
        lane = p_idx * n_loc + jnp.arange(n_loc)   # global lane ids
    else:
        lane = jnp.arange(n_static)
    alive = lane < jnp.asarray(num_particles)
    neg_inf = jnp.asarray(-jnp.inf, dtype=dtype)

    if threshold is None:
        thr = n_f / 2.0 if resample_algorithm == "SISAR" else None
    else:
        thr = jnp.asarray(threshold, dtype=dtype)

    uniform_w = jnp.where(alive, 1.0 / n_f, 0.0).astype(dtype)

    always_resample = algorithm == "RMPF" or resample_algorithm == "SISR"

    canon_in_scan = canon

    def squeeze_y(y_row):
        return y_row[0] if d_y == 1 else y_row

    log_uniform_w = jnp.where(alive, -jnp.log(n_f), neg_inf).astype(dtype)

    def step(carry, xs):
        particles, lnw_prev, loglike, dead = carry
        y_row, gap_i, t_i, step_keys = xs
        y_i = squeeze_y(y_row)
        # Per-step keys come pre-split from one batched call outside the
        # scan: a 6-way split inside every iteration cost ~6.6 ms/sweep at
        # 4096 chains (threefry on tiny shapes is latency-bound).
        k_gap, k_aux, k_trans2, k_res, k_move = (
            step_keys[j] for j in range(5)
        )
        if sharded:
            # Model randomness is per-shard; k_aux/k_res (resampling
            # positions) stay identical across shards.
            k_gap = jax.random.fold_in(k_gap, p_idx)
            k_trans2 = jax.random.fold_in(k_trans2, p_idx)
            k_move = jax.random.fold_in(k_move, p_idx)

        # --- propagate through observation-time gaps (:122-137) ---
        if plain_gaps:
            particles = canon_in_scan(
                trans(key=k_gap, particles=particles, t=t_i, **theta),
                "transition_fn",
            )
        else:
            def prop_step(p, s):
                kk = jax.random.fold_in(k_gap, s)
                tnow = t_i - gap_i + s + 1
                newp = canon_in_scan(
                    trans(key=kk, particles=p, t=tnow, **theta), "transition_fn"
                )
                return jnp.where(s < gap_i, newp, p), None

            particles, _ = lax.scan(
                prop_step, particles, jnp.arange(max_gap)
            )

        # --- weights (APF lookahead branch: :139-175) ---
        if algorithm == "APF":
            aux_lw = jnp.asarray(
                auxw(y=y_i, particles=particles, t=t_i, **theta)
            )
            if aux_lw.shape[-1] != n_loc:
                raise ValueError("aux_weight_fn must return num_particles")
            aux_lw = jnp.where(alive, aux_lw, neg_inf)
            # Degenerate AUX weights kill the chain like degenerate main
            # weights: the reference's sample() errors on all-zero
            # auxiliary probabilities; mapping it to the same -inf
            # contract keeps PMMH safe.
            aux_max = jnp.max(aux_lw)
            if sharded:
                aux_max = lax.pmax(aux_max, particle_axis)
            dead = jnp.logical_or(dead, aux_max < DEGENERATE_LOG_WEIGHT)
            aux_base = aux_lw + lnw_prev if carry_weights else aux_lw
            if sharded:
                aux_weights, _, _ = normalize_log_weights(
                    aux_base, axis_name=particle_axis
                )
                ancestors = sharded_resample_indices(
                    k_aux, aux_weights, resample_fn, particle_axis, n_f
                )
                particles = sharded_gather(particles, ancestors, particle_axis)
                aux_anc = sharded_gather(aux_lw, ancestors, particle_axis)
            else:
                aux_weights, _, _ = normalize_log_weights(aux_base)
                ancestors = resample_indices(
                    k_aux, aux_weights, method=resample_fn, num_alive=n_f
                )
                particles = gather_particles(particles, ancestors)
                aux_anc = jnp.take(aux_lw, ancestors)
            # Q2: second transition after auxiliary resampling (:159).
            particles = canon_in_scan(
                trans(key=k_trans2, particles=particles, t=t_i, **theta),
                "transition_fn",
            )
            lw = jnp.asarray(weight(y=y_i, particles=particles, t=t_i, **theta))
            if lw.shape[-1] != n_loc:
                raise ValueError("weight_fn must return num_particles")
            lw = lw - aux_anc
        else:
            lw = jnp.asarray(weight(y=y_i, particles=particles, t=t_i, **theta))
            if lw.shape[-1] != n_loc:
                raise ValueError("weight_fn must return num_particles")
        lw = jnp.where(alive, lw.astype(dtype), neg_inf)

        # --- degenerate-weight detection (:189-202) ---
        lw_max = jnp.max(lw)
        if sharded:
            lw_max = lax.pmax(lw_max, particle_axis)
        dead = jnp.logical_or(dead, lw_max < DEGENERATE_LOG_WEIGHT)

        if carry_weights:
            # Textbook accumulation: incr = logsumexp(lnW_{t-1} + lw_t).
            # After an APF step lnw_prev is already uniform (the auxiliary
            # resample consumed the carried weights).
            base = log_uniform_w if algorithm == "APF" else lnw_prev
            combined = lw + base
        else:
            combined = lw

        # --- normalise, likelihood increment, ESS, resample (:204-224);
        # collective when sharded ---
        weights, lse, mx = normalize_log_weights(
            combined, axis_name=particle_axis
        )
        incr = (mx + lse) if carry_weights else (mx + lse - jnp.log(n_f))
        loglike = jnp.where(dead, neg_inf, loglike + incr)

        ess = effective_sample_size(weights, axis_name=particle_axis)
        if always_resample:
            should = None  # statically always resample
        elif resample_algorithm == "SIS":
            should = False
        else:
            should = ess < thr

        if should is not False:
            if sharded:
                idx = sharded_resample_indices(
                    k_res, weights, resample_fn, particle_axis, n_f
                )
                resampled = sharded_gather(particles, idx, particle_axis)
            else:
                idx = resample_indices(
                    k_res, weights, method=resample_fn, num_alive=n_f
                )
                resampled = gather_particles(particles, idx)
            if should is None:
                particles = resampled
                weights = uniform_w
                ess_rec = n_f
            else:
                particles = jnp.where(should, resampled, particles)
                weights = jnp.where(should, uniform_w, weights)
                ess_rec = jnp.where(should, n_f, ess)
        else:
            ess_rec = ess

        # --- RMPF rejuvenation move, vectorized over particles (:226-234) ---
        if algorithm == "RMPF":
            particles = canon_in_scan(
                move(key=k_move, particles=particles, y=y_i, t=t_i, **theta),
                "move_fn",
            )

        # Dead chains: zero weights so the recorded state estimate and ESS
        # collapse to 0, matching the reference's early-return zeros.
        weights = jnp.where(dead, jnp.zeros_like(weights), weights)
        ess_rec = jnp.where(dead, jnp.zeros_like(ess_rec), ess_rec)

        pos = weights > 0
        lnw_new = jnp.where(pos, jnp.log(jnp.where(pos, weights, 1.0)), neg_inf)

        # A float32 product on the GPU may run in TF32 (about three
        # decimal digits); the state estimate is a reported result.
        state_est = jnp.einsum(
            "n,n...->...", weights, particles, precision="highest"
        )
        if sharded:
            state_est = lax.psum(state_est, particle_axis)

        out = (state_est, ess_rec, loglike)
        if return_particles:
            out = out + (particles, weights)
        return (particles, lnw_new, loglike, dead), out

    xs = (
        ys,
        jnp.asarray(gaps, dtype=jnp.int32),
        jnp.asarray(ot, dtype=jnp.int32),
        jax.random.split(key, (num_obs, 5)),
    )
    carry0 = (
        particles0,
        log_uniform_w,
        jnp.zeros((), dtype=dtype),
        jnp.zeros((), dtype=bool),
    )
    (_, _, loglike, _), outs = lax.scan(step, carry0, xs)

    if return_particles:
        state_seq, ess_seq, llh, particles_seq, weights_seq = outs
    else:
        state_seq, ess_seq, llh = outs
        particles_seq = weights_seq = None

    # t = 0 entries (:105-116): uniform weights, ESS = n, weighted-mean state.
    state0 = jnp.einsum(
        "n,n...->...", uniform_w, particles0, precision="highest"
    )
    if sharded:
        state0 = lax.psum(state0, particle_axis)
    state_est = jnp.concatenate([state0[None], state_seq], axis=0)
    ess_vec = jnp.concatenate([n_f[None], ess_seq], axis=0)

    if return_particles:
        particles_hist = jnp.concatenate([particles0[None], particles_seq], axis=0)
        weights_hist = jnp.concatenate([uniform_w[None], weights_seq], axis=0)
    else:
        particles_hist = weights_hist = None

    return FilterResult(
        state_est=state_est,
        ess=ess_vec,
        loglike=loglike,
        loglike_history=llh,
        algorithm=algorithm,
        resample_algorithm=resample_algorithm,
        particles_history=particles_hist,
        weights_history=weights_hist,
    )
