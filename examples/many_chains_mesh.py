"""Scale-out example: thousands of chains on a device mesh.

Runs PMMH with the chains axis sharded over all available devices, and
demonstrates the particle-sharded distributed filter. On a host with
several GPUs this is the production layout (no communication in the
sampling hot loop); on CPU it runs on virtual devices via
XLA_FLAGS=--xla_force_host_platform_device_count=8.

Run: python examples/many_chains_mesh.py
Scale-out guidance: docs/guide.md section 5.
"""

import jax
import jax.numpy as jnp

from bayesssm_tpu.models.lgss import lgss_model, simulate_lgss
from bayesssm_tpu.parallel.mesh import make_chain_mesh
from bayesssm_tpu.parallel.sharded import sharded_bootstrap_filter
from bayesssm_tpu.pmmh.driver import pmmh
from bayesssm_tpu.pmmh.tuning import default_tune_control


def main():
    (init_fn, transition_fn, log_likelihood_fn), log_priors, transform = (
        lgss_model()
    )
    _, y = simulate_lgss(1405, t_val=25)

    n_dev = len(jax.devices())
    mesh = make_chain_mesh(n_dev)
    num_chains = 4 * n_dev

    result = pmmh(
        "bootstrap_filter", y, m=200,
        init_fn=init_fn, transition_fn=transition_fn,
        log_likelihood_fn=log_likelihood_fn, log_priors=log_priors,
        pilot_init_params=[{"a": 0.5, "sigma_x": 0.5, "sigma_y": 0.5}]
        * num_chains,
        burn_in=50, num_chains=num_chains, seed=0,
        param_transform=transform,
        tune_control=default_tune_control(pilot_m=100, pilot_reps=20),
        mesh=mesh,
    )

    # Particle-axis sharding: one huge filter spread across devices.
    mesh2 = make_chain_mesh(n_dev, particle_axis_size=min(4, n_dev))
    theta = {k: jnp.full((4,), v) for k, v in
             {"a": 0.9, "sigma_x": 0.6, "sigma_y": 0.4}.items()}
    ll, states = sharded_bootstrap_filter(
        jax.random.key(0), y, 4096, init_fn, transition_fn,
        log_likelihood_fn, theta, num_chains=4, mesh=mesh2,
        resample_algorithm="SISR",
    )
    print("sharded filter loglikes:", ll)
    return result


if __name__ == "__main__":
    main()
