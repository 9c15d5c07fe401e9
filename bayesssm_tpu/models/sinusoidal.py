"""Sinusoidal AR(1) state-space model — the README parity model.

Model (/root/reference/README.md:90-150):
    x_0 ~ N(0, 1)
    x_t = phi * x_{t-1} + sin(x_{t-1}) + N(0, sigma_x^2)
    y_t = x_t + N(0, sigma_y^2)
Priors: phi ~ Unif(0, 1), sigma_x ~ Exp(1), sigma_y ~ Exp(1).
Reference posterior anchor (seed 1405, m=500, 2 chains): see BASELINE.md.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from bayesssm_tpu.models.distributions import (
    exp_logpdf,
    norm_logpdf,
    unif_logpdf,
)

__all__ = [
    "sinusoidal_model",
    "simulate_sinusoidal",
    "sinusoidal_sweep_pf_impl",
]


def sinusoidal_model():
    """Return (model_fns, log_priors, param_transform) for the README model."""

    def init_fn(key, num_particles):
        return jax.random.normal(key, (num_particles,))

    def transition_fn(key, particles, phi, sigma_x):
        noise = jax.random.normal(key, particles.shape)
        return phi * particles + jnp.sin(particles) + sigma_x * noise

    def log_likelihood_fn(y, particles, sigma_y):
        return norm_logpdf(y, mean=particles, sd=sigma_y)

    log_priors = {
        "phi": lambda phi: unif_logpdf(phi, 0.0, 1.0),
        "sigma_x": lambda s: exp_logpdf(s, 1.0),
        "sigma_y": lambda s: exp_logpdf(s, 1.0),
    }
    # The README's pmmh call uses no transform (identity everywhere); the
    # log transform for the scale parameters improves mixing and is what the
    # pmmh() Rd example uses.
    param_transform = {"phi": "identity", "sigma_x": "log", "sigma_y": "log"}
    return (init_fn, transition_fn, log_likelihood_fn), log_priors, param_transform


def sinusoidal_sweep_pf_impl(interpret: bool = False):
    """Whole-sweep ``pf_impl`` for the README model — a builder instance.

    The reference's flagship example (/root/reference/README.md:100-211,
    BASELINE.json config 1) on the whole-sweep kernel: one state column,
    Box-Muller normals from the in-kernel stream, Gaussian log-weights,
    inverse-CDF resample.
    Usage: ``pmmh(..., pf_impl=sinusoidal_sweep_pf_impl())``. Sampling
    distribution matches the portable ``sinusoidal_model()`` filters
    (bit-streams differ; parity is distributional).
    """
    from bayesssm_tpu.ops.sweep_builder import build_sweep_pf_impl

    half_log_2pi = np.float32(0.5 * np.log(2.0 * np.pi))

    def init_fn(rng, theta):
        return (rng.normal(),)

    def transition_fn(rng, cols, theta, t):
        phi, sigma_x, _ = theta
        x = cols[0]
        return (phi * x + jnp.sin(x) + sigma_x * rng.normal(),)

    def log_weight_fn(cols, theta, y_t):
        _, _, sigma_y = theta
        r = (y_t - cols[0]) / sigma_y
        return -0.5 * r * r - jnp.log(sigma_y) - half_log_2pi

    return build_sweep_pf_impl(
        1, init_fn, transition_fn, log_weight_fn,
        ("phi", "sigma_x", "sigma_y"), interpret=interpret,
    )


def simulate_sinusoidal(seed=1405, t_val=20, phi=0.8, sigma_x=1.0, sigma_y=0.5):
    """Simulate data like README.md:96-115. Returns (x [T+1], y [T])."""
    rng = np.random.default_rng(seed)
    x = np.zeros(t_val + 1)
    y = np.zeros(t_val)
    x[0] = rng.normal()
    for t in range(t_val):
        x[t + 1] = phi * x[t] + np.sin(x[t]) + sigma_x * rng.normal()
        y[t] = x[t + 1] + sigma_y * rng.normal()
    return x, y
