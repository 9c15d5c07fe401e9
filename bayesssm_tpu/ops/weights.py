"""Weight-normalization primitives for SMC.

Vectorized replacement for the inline weight arithmetic of the reference's
filter core (/root/reference/R/particle_filter_core.R:204-212): max-shifted
log-sum-exp normalization, per-step marginal-likelihood increments, and the
inverse-sum-of-squares effective sample size. Everything is pure, branchless
and shaped for `vmap` over a leading chains axis.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

__all__ = ["normalize_log_weights", "effective_sample_size", "log_mean_exp"]

# Log-weights below this (after masking) are treated as dead lanes. The
# reference's degenerate-weight early exit triggers when all log-weights are
# below -1e8 (/root/reference/R/particle_filter_core.R:189-191).
DEGENERATE_LOG_WEIGHT = -1.0e8

_NEG_INF = -jnp.inf


def normalize_log_weights(
    log_weights: jnp.ndarray, axis: int = -1, axis_name: str | None = None
):
    """Max-shifted normalization of log-weights.

    Returns ``(weights, log_sum_exp_shifted, max_logw)`` where ``weights``
    are the self-normalized importance weights and
    ``max_logw + log_sum_exp_shifted`` is ``logsumexp(log_weights)``.

    Mirrors /root/reference/R/particle_filter_core.R:204-207 but keeps the
    pieces needed for the likelihood-increment telescoping product so callers
    never re-exponentiate.

    Masked (``-inf``) lanes contribute zero weight. If *all* lanes are
    ``-inf`` the weights come back as zeros (not NaN) so degenerate filters
    propagate a ``-inf`` log-likelihood without poisoning later arithmetic.

    ``axis_name``: optional mesh axis the particle dimension is sharded
    over. The local max/sum reductions are then completed with
    ``pmax``/``psum`` collectives, so the returned pieces are GLOBAL — the
    telescoping marginal-likelihood increment stays exactly the
    single-device ``max + log(sum exp(lw - max))`` (unbiasedness under
    sharded resampling, BASELINE.md config 2).
    """
    max_logw = jnp.max(log_weights, axis=axis, keepdims=True)
    if axis_name is not None:
        max_logw = lax.pmax(max_logw, axis_name)
    # Guard fully-degenerate slices: exp(-inf - (-inf)) would be NaN.
    safe_max = jnp.where(jnp.isfinite(max_logw), max_logw, 0.0)
    unnorm = jnp.exp(log_weights - safe_max)
    wsum = jnp.sum(unnorm, axis=axis, keepdims=True)
    if axis_name is not None:
        wsum = lax.psum(wsum, axis_name)
    weights = jnp.where(wsum > 0.0, unnorm / jnp.where(wsum > 0.0, wsum, 1.0), 0.0)
    lse = jnp.log(jnp.where(wsum > 0.0, wsum, 1.0))
    lse = jnp.where(wsum > 0.0, lse, _NEG_INF)
    return (
        weights,
        jnp.squeeze(lse, axis=axis),
        jnp.squeeze(max_logw, axis=axis),
    )


def log_mean_exp(log_values: jnp.ndarray, num: jnp.ndarray | float, axis: int = -1):
    """``logsumexp(log_values) - log(num)``: one step's likelihood increment.

    ``num`` may be a traced per-chain particle count (masked-particle mode,
    see SURVEY.md §7 step 4) — hence it is not derived from the array shape.
    Matches /root/reference/R/particle_filter_core.R:208.
    """
    _, lse, max_logw = normalize_log_weights(log_values, axis=axis)
    return max_logw + lse - jnp.log(num)


def effective_sample_size(
    weights: jnp.ndarray, axis: int = -1, axis_name: str | None = None
):
    """ESS = 1 / sum(w_i^2) of self-normalized weights.

    Matches /root/reference/R/particle_filter_core.R:211. Degenerate
    (all-zero) weight slices return 0 rather than inf. ``axis_name``
    completes the reduction over a sharded particle mesh axis.
    """
    denom = jnp.sum(jnp.square(weights), axis=axis)
    if axis_name is not None:
        denom = lax.psum(denom, axis_name)
    return jnp.where(denom > 0.0, 1.0 / jnp.where(denom > 0.0, denom, 1.0), 0.0)
