"""Whole-sweep kernels for YOUR model: the sweep builder.

The fastest path in this framework runs the ENTIRE particle filter in
one Pallas kernel compiled through Triton for an NVIDIA GPU.
`ops/sweep_builder.py` makes that available for any model with [B, N]
float state columns: write three small callbacks (they trace INTO the
kernel, so use jnp elementwise ops only) and get a `pf_impl` for `pmmh`.

Here: the stochastic-volatility model (models/stochastic_volatility.py),
which has no bespoke kernel.

Run on a machine with an NVIDIA GPU: python examples/custom_sweep_kernel.py
(The chain is kept demo-short — expect the printed Rhat warning; SV
posteriors need longer series and chains than a minutes-long example
affords. The same callbacks run on the CPU under the Pallas interpreter
with ``interpret=True``, which is how tests/test_sweep_builder.py checks
them.)
"""

import jax.numpy as jnp
import numpy as np

from bayesssm_tpu import default_tune_control, pmmh
from bayesssm_tpu.models.stochastic_volatility import simulate_sv, sv_model
from bayesssm_tpu.ops.sweep_builder import build_sweep_pf_impl

HALF_LOG_2PI = 0.5 * np.log(2.0 * np.pi)


# --- the three callbacks: the model, written for the kernel ---------
# Contract (ops/sweep_builder.py docstring): every state column and every
# rng.normal()/rng.uniform() is a [B, N] float32 block; theta is a tuple
# of per-chain parameter broadcasts ordered as param_names below.

def sv_init(rng, theta):
    phi, sigma, mu = theta
    sd0 = sigma / jnp.sqrt(1.0 - phi * phi)
    return (mu + sd0 * rng.normal(),)


def sv_transition(rng, cols, theta, t):
    phi, sigma, mu = theta
    return (mu + phi * (cols[0] - mu) + sigma * rng.normal(),)


def sv_log_weight(cols, theta, y_t):
    x = cols[0]
    return -HALF_LOG_2PI - 0.5 * x - 0.5 * y_t * y_t * jnp.exp(-x)


def main():
    _, y = simulate_sv(seed=7, t_val=40, phi=0.95, sigma=0.3, mu=-1.0)

    pf_impl = build_sweep_pf_impl(
        num_state_cols=1,
        init_fn=sv_init,
        transition_fn=sv_transition,
        log_weight_fn=sv_log_weight,
        param_names=("phi", "sigma", "mu"),
    )

    # The driver still wants the plain model functions for signature
    # validation (and they remain the reference implementation the
    # kernel is tested against).
    (init_fn, trans_fn, loglik_fn), log_priors, transform = sv_model()

    out = pmmh(
        "bootstrap_filter", np.asarray(y, np.float32), 300,
        init_fn, trans_fn, loglik_fn, log_priors,
        pilot_init_params=[
            {"phi": 0.9, "sigma": 0.5, "mu": -0.5},
            {"phi": 0.95, "sigma": 0.2, "mu": -1.5},
        ],
        burn_in=75, num_chains=2, seed=1405, param_transform=transform,
        tune_control=default_tune_control(
            pilot_m=150, pilot_burn_in=40, pilot_reps=10
        ),
        pf_impl=pf_impl,
        print_summary=True,
    )
    s = out.summary()
    print(
        "\nposterior means:",
        {p: round(s[p]["mean"], 3) for p in ("phi", "sigma", "mu")},
        "(truth: phi=0.95 sigma=0.3 mu=-1.0)",
    )


if __name__ == "__main__":
    main()
