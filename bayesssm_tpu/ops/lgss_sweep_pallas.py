"""Whole-sweep kernel for the linear-Gaussian SSM — a builder instance.

The ENTIRE T-observation bootstrap filter in ONE Triton kernel
(ops/sweep_builder.py) from three small callbacks: Box-Muller normals
from the in-kernel stream, Gaussian log-weights, and the inverse-CDF
resample per observation. Because the LGSS has an EXACT Kalman ground
truth (utils/kalman.py), it anchors the builder's scaffold to an
analytic log-marginal likelihood (tests/test_lgss_sweep.py in interpret
mode, tests/test_sweep_kernel.py compiled on the card).

Model (models/lgss.py, /root/reference vignette's AR(1) family):
    x_0 ~ N(0, p0^2),  x_t = a x_{t-1} + sigma_x eps_t,
    y_t ~ N(c x_t, sigma_y^2).

The state is ONE float column and the resample copies values exactly,
so there is no packing. Selection needs sorted positions
(stratified/systematic); multinomial raises.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

from bayesssm_tpu.ops.sweep_builder import build_sweep_op

__all__ = ["lgss_bpf_sweep", "lgss_mv_bpf_sweep", "lgss_sweep_pf_impl"]

_HALF_LOG_2PI = np.float32(0.5 * np.log(2.0 * np.pi))


@functools.lru_cache(maxsize=None)
def _lgss_op(c_coef: float, p0: float, resample_fn: str,
             always_resample: bool, never_resample: bool,
             interpret: bool):
    c32 = np.float32(c_coef)
    p032 = np.float32(p0)

    def init(rng, theta):
        return (p032 * rng.normal(),)

    def trans(rng, cols, theta, t):
        a, sx, _ = theta
        return (a * cols[0] + sx * rng.normal(),)

    def lw(cols, theta, y_t):
        _, _, sy = theta
        resid = (y_t - c32 * cols[0]) / sy
        return -0.5 * resid * resid - jnp.log(sy) - _HALF_LOG_2PI

    return build_sweep_op(
        1, init, trans, lw, 3, resample_fn=resample_fn,
        always_resample=always_resample,
        never_resample=never_resample, interpret=interpret,
    )


def lgss_bpf_sweep(
    key,
    y,
    num_particles,
    a,
    sigma_x,
    sigma_y,
    c: float = 1.0,
    p0: float = 1.0,
    max_particles: int | None = None,
    resample_fn: str = "stratified",
    resample_algorithm: str = "SISAR",
    threshold=None,
    interpret: bool = False,
):
    """Full LGSS bootstrap-filter sweep in one Triton kernel.

    Same contract shape as ``sir_bpf_sweep``: returns
    ``(loglike, state_est [T+1])`` distribution-identical to
    ``bootstrap_filter`` over ``lgss_model(c, p0)`` (bit-streams differ;
    the log-marginal likelihood is Kalman-anchored in
    tests/test_lgss_sweep.py). ``resample_fn`` must be stratified or
    systematic.
    """
    if resample_algorithm not in ("SIS", "SISR", "SISAR"):
        raise ValueError("lgss_bpf_sweep supports SIS, SISR or SISAR")
    if resample_fn not in ("stratified", "systematic"):
        raise ValueError(
            "lgss_bpf_sweep resamples by a search over sorted positions "
            "(stratified/systematic)"
        )
    op = _lgss_op(
        float(c), float(p0), resample_fn,
        resample_algorithm == "SISR", resample_algorithm == "SIS",
        bool(interpret),
    )
    theta_vec = jnp.stack([
        jnp.asarray(a, jnp.float32).reshape(()),
        jnp.asarray(sigma_x, jnp.float32).reshape(()),
        jnp.asarray(sigma_y, jnp.float32).reshape(()),
    ])
    return op(
        key, y, theta_vec, num_particles,
        max_particles=max_particles, threshold=threshold,
    )


@functools.lru_cache(maxsize=None)
def _lgss_mv_op(c1: float, c2: float, p0: float, resample_fn: str,
                always_resample: bool, obs_gaps, interpret: bool):
    c1f, c2f = np.float32(c1), np.float32(c2)
    p032 = np.float32(p0)

    def init(rng, theta):
        return (p032 * rng.normal(),)

    def trans(rng, cols, theta, t):
        a, sx = theta[0], theta[1]
        return (a * cols[0] + sx * rng.normal(),)

    def lw(cols, theta, y_t):
        sy1, sy2 = theta[2], theta[3]
        y1, y2 = y_t                       # one [T, 2] row as scalars
        r1 = (y1 - c1f * cols[0]) / sy1
        r2 = (y2 - c2f * cols[0]) / sy2
        return (
            -0.5 * (r1 * r1 + r2 * r2)
            - jnp.log(sy1) - jnp.log(sy2) - 2.0 * _HALF_LOG_2PI
        )

    return build_sweep_op(
        1, init, trans, lw, 4, resample_fn=resample_fn,
        always_resample=always_resample, interpret=interpret,
        num_obs_cols=2, obs_gaps=obs_gaps,
    )


def lgss_mv_bpf_sweep(
    key,
    y,
    num_particles,
    a,
    sigma_x,
    sigma_y_vec,
    c_vec=(1.0, 0.5),
    p0: float = 1.0,
    obs_times=None,
    max_particles: int | None = None,
    resample_fn: str = "stratified",
    resample_algorithm: str = "SISAR",
    threshold=None,
    interpret: bool = False,
):
    """Vector-observation LGSS whole sweep (scalar state, d_y = 2).

    Exercises the builder's multivariate observation rows
    (``num_obs_cols=2``: each day reads ``y[t, :]`` as scalars,
    /root/reference/R/particle_filter_core.R:176-183) and, when
    ``obs_times`` is given, the in-kernel gap-propagation loop
    (:122-137). Kalman-anchored against
    ``utils/kalman.py::kalman_loglik_mv`` (tests/test_lgss_sweep.py).

    Model: ``x_0 ~ N(0, p0^2)``, ``x_t = a x_{t-1} + N(0, sigma_x^2)``,
    ``y_t = c_vec x_t + N(0, diag(sigma_y_vec^2))``.
    """
    if resample_algorithm not in ("SISR", "SISAR"):
        raise ValueError("lgss_mv_bpf_sweep supports SISR or SISAR only")
    c1, c2 = (float(v) for v in c_vec)
    sy1, sy2 = (jnp.asarray(v, jnp.float32).reshape(()) for v in sigma_y_vec)
    if obs_times is not None:
        from bayesssm_tpu.filters.core import obs_times_to_gaps

        obs_gaps = obs_times_to_gaps(obs_times, int(jnp.asarray(y).shape[0]))
    else:
        obs_gaps = None
    op = _lgss_mv_op(
        c1, c2, float(p0), resample_fn,
        resample_algorithm == "SISR", obs_gaps, bool(interpret),
    )
    theta_vec = jnp.stack([
        jnp.asarray(a, jnp.float32).reshape(()),
        jnp.asarray(sigma_x, jnp.float32).reshape(()),
        sy1, sy2,
    ])
    return op(
        key, y, theta_vec, num_particles,
        max_particles=max_particles, threshold=threshold,
    )


def lgss_sweep_pf_impl(c: float = 1.0, p0: float = 1.0,
                       interpret: bool = False):
    """PMMH ``pf_impl`` factory for the LGSS whole-sweep kernel.

    A builder instance (ops/sweep_builder.py): parameters
    {a, sigma_x, sigma_y} as in ``models/lgss.py::lgss_model``.
    """
    def factory(
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
    ):
        del model_fns
        if algorithm != "BPF":
            raise ValueError("lgss_sweep_pf_impl supports BPF only")
        if obs_times is not None:
            raise ValueError(
                "lgss_sweep_pf_impl supports contiguous obs_times only"
            )
        if carry_weights:
            raise ValueError(
                "lgss_sweep_pf_impl implements the reference fresh-weight "
                "semantics (carry_weights=False)"
            )
        if set(param_names) != {"a", "sigma_x", "sigma_y"}:
            raise ValueError(
                "lgss_sweep_pf_impl expects parameters "
                "{'a', 'sigma_x', 'sigma_y'}"
            )
        j_a = param_names.index("a")
        j_sx = param_names.index("sigma_x")
        j_sy = param_names.index("sigma_y")
        ys = jnp.asarray(y, jnp.float32)

        def pf(key, theta_vec, n=num_particles):
            return lgss_bpf_sweep(
                key, ys, n, theta_vec[j_a], theta_vec[j_sx],
                theta_vec[j_sy], c=c, p0=p0,
                max_particles=max_particles
                if max_particles is not None
                else n,
                resample_fn=resample_fn,
                resample_algorithm=resample_algorithm,
                interpret=interpret,
            )

        return pf

    return factory
