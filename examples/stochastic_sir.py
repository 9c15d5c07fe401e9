"""Stochastic SIR epidemic inference — the vignette example.

Python analogue of /root/reference/vignettes/articles/
stochastic-sir-model.Rmd: a closed-population continuous-time SIR model
with Poisson-observed infectious counts; the transition is an exact
vectorized Gillespie simulation running on device.

Run: python examples/stochastic_sir.py
Narrative walkthrough with measured posteriors: docs/sir_walkthrough.md;
simulator trade-offs (exact gillespie vs approximate tauleap, and the
whole-sweep kernel): docs/performance.md.
"""

from bayesssm_tpu.models.sir import simulate_sir, sir_model
from bayesssm_tpu.pmmh.driver import pmmh
from bayesssm_tpu.pmmh.tuning import default_tune_control


def main():
    (init_fn, transition_fn, log_likelihood_fn), log_priors, transform = (
        sir_model(n_total=500, init_infected=70)
    )
    states, y = simulate_sir(seed=1405, lam=0.5, gamma=0.2)
    print("observed counts:", y)

    result = pmmh(
        "bootstrap_filter",
        y,
        m=1000,
        init_fn=init_fn,
        transition_fn=transition_fn,
        log_likelihood_fn=log_likelihood_fn,
        log_priors=log_priors,
        pilot_init_params=[
            {"lam": 0.5, "gamma": 0.5},
            {"lam": 1.0, "gamma": 1.0},
        ],
        burn_in=200,
        num_chains=2,
        seed=1405,
        param_transform=transform,
        tune_control=default_tune_control(pilot_m=100),
        verbose=True,
    )
    print("true lambda=0.5, gamma=0.2")
    return result


if __name__ == "__main__":
    main()
