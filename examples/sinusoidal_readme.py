"""README example: PMMH on the sinusoidal AR(1) SSM.

Python analogue of /root/reference/README.md:96-211 — simulate 20
observations with phi=0.8, sigma_x=1, sigma_y=0.5, then recover the
posterior with a bootstrap-filter PMMH (2 chains, pilot-tuned).

Run: python examples/sinusoidal_readme.py [--fused]
``--fused`` routes BOTH PMMH phases through the model's whole-sweep
builder instance (`sinusoidal_sweep_pf_impl`) — the entire filter in
one Triton kernel, which needs an NVIDIA GPU; same posterior, fastest
path.
API overview: docs/guide.md; filter variants: docs/filters.md.
"""

import sys

from bayesssm_tpu.models.sinusoidal import (
    simulate_sinusoidal,
    sinusoidal_model,
    sinusoidal_sweep_pf_impl,
)
from bayesssm_tpu.pmmh.driver import pmmh
from bayesssm_tpu.pmmh.tuning import default_tune_control


def main():
    (init_fn, transition_fn, log_likelihood_fn), log_priors, transform = (
        sinusoidal_model()
    )
    _, y = simulate_sinusoidal(seed=1405, t_val=20)

    pf_impl = sinusoidal_sweep_pf_impl() if "--fused" in sys.argv else None

    result = pmmh(
        "bootstrap_filter",
        y,
        m=500,
        pf_impl=pf_impl,
        init_fn=init_fn,
        transition_fn=transition_fn,
        log_likelihood_fn=log_likelihood_fn,
        log_priors=log_priors,
        pilot_init_params=[
            {"phi": 0.4, "sigma_x": 0.4, "sigma_y": 0.4},
            {"phi": 0.8, "sigma_x": 0.8, "sigma_y": 0.8},
        ],
        burn_in=50,
        num_chains=2,
        seed=1405,
        param_transform=transform,
        tune_control=default_tune_control(pilot_m=200),
        verbose=True,
    )
    print("acceptance rates:", result.acceptance_rate)
    print("tuned particle counts:", result.target_n)
    return result


if __name__ == "__main__":
    main()
