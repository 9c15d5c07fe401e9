"""Benchmark: aggregate PMMH samples/s at 4096 chains on stochastic-SIR.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device"}.
It runs on an NVIDIA GPU only and stops when JAX finds none; "device"
names the platform, device kind and count, and the card's name and power
limit.

The default workload is BASELINE.json's north-star config (3): bootstrap-
filter PMMH on the stochastic SIR model (n_total=500, 70 initially
infected, T=10 daily Poisson observations), 4096 chains running the full
MH step (MVN propose in log-space -> full particle-filter sweep with exact
vectorized Gillespie dynamics -> accept/reject) on device. ``--config``
selects the filter variant:

  bpf  (default) — bootstrap filter          (BASELINE.json config 3)
  apf            — auxiliary filter lookahead (config 4)
  rmpf           — resample-move rejuvenation (config 5)
  pmmh           — the PUBLIC ``pmmh()`` driver end-to-end (pilot tuning +
                   chunked sampling, the real two-phase pipeline); phase
                   timings go to stderr, the JSON line reports
                   sampling-phase samples/s.

``vs_baseline`` is the speedup over a measured single-core NumPy
implementation of the same sampler/filter (baselines/single_core_numpy.py)
— the reference R package publishes no numbers and R is unavailable here
(BASELINE.md). The baseline is the median of ``--baseline-reps`` repeats
to keep the denominator stable.

Usage: python bench.py [--quick] [--config C] [--chains C] [--particles N]
                       [--steps K]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

CONFIGS = ("bpf", "apf", "rmpf", "pmmh", "sinusoidal")

# Per-config MH-harness parameters: generating theta (timed at truth for
# run-to-run stability) and log-space proposal sd. SIR configs sample
# (lam, gamma); "sinusoidal" samples (phi, sigma_x, sigma_y) of the
# README model (BASELINE.json config 1).
_THETA0 = {"sinusoidal": (0.8, 1.0, 0.5)}
_PROP_SD = {"sinusoidal": (0.05, 0.1, 0.1)}


def _build_pf_loglike(config, ys, particles, transition):
    """(key, theta_vec) -> loglike for one chain, per filter config."""
    import jax.numpy as jnp

    from bayesssm_tpu.filters.auxiliary import auxiliary_filter
    from bayesssm_tpu.filters.bootstrap import bootstrap_filter
    from bayesssm_tpu.filters.resample_move import resample_move_filter
    from bayesssm_tpu.models.sir import (
        sir_aux_log_likelihood_fn,
        sir_model,
        sir_move_fn,
    )

    if config == "sinusoidal":
        # README model through its whole-sweep builder instance
        # (models/sinusoidal.py); log_priors order (phi, sigma_x,
        # sigma_y) matches _THETA0.
        from bayesssm_tpu.models.sinusoidal import (
            sinusoidal_model,
            sinusoidal_sweep_pf_impl,
        )

        _, log_priors, _ = sinusoidal_model()
        prior_fns = [log_priors[p] for p in log_priors]
        pf = sinusoidal_sweep_pf_impl()(
            y=jnp.asarray(ys, jnp.float32), num_particles=particles,
            param_names=["phi", "sigma_x", "sigma_y"], model_fns=None,
            obs_times=None, algorithm="BPF", resample_algorithm="SISAR",
            resample_fn="stratified", carry_weights=False,
        )

        def pf_loglike(key, theta_vec):
            ll, _ = pf(key, theta_vec)
            return ll

        return pf_loglike, prior_fns

    # The whole-sweep kernel serves every filter variant: BPF, the APF's
    # Q2 double-transition + aux-resample stage, and the RMPF's forced
    # SISR + in-kernel rejuvenation move.
    if transition == "sir_sweep":
        from bayesssm_tpu.ops.sir_sweep_pallas import sir_filter_sweep

        algo = {"bpf": "BPF", "pmmh": "BPF", "apf": "APF",
                "rmpf": "RMPF"}[config]
        _, log_priors, _ = sir_model(n_total=500, init_infected=70)
        param_names = list(log_priors)
        prior_fns = [log_priors[p] for p in param_names]
        j_lam = param_names.index("lam")
        j_gam = param_names.index("gamma")
        ys_sweep = jnp.asarray(ys, dtype=jnp.float32)

        def pf_loglike(key, theta_vec):
            ll, _ = sir_filter_sweep(
                key, ys_sweep, particles, theta_vec[j_lam],
                theta_vec[j_gam], 500, 70, algorithm=algo,
            )
            return ll

        return pf_loglike, prior_fns
    (init_fn, transition_fn, loglik_fn), log_priors, _ = sir_model(
        n_total=500, init_infected=70, transition=transition
    )
    param_names = list(log_priors)
    prior_fns = [log_priors[p] for p in param_names]
    ys = jnp.asarray(ys, dtype=jnp.float32)

    def pf_loglike(key, theta_vec):
        theta = {p: theta_vec[j] for j, p in enumerate(param_names)}
        if config == "apf":
            res = auxiliary_filter(
                key, ys, particles, init_fn, transition_fn, loglik_fn,
                aux_log_likelihood_fn=sir_aux_log_likelihood_fn,
                theta=theta, return_particles=False,
            )
        elif config == "rmpf":
            res = resample_move_filter(
                key, ys, particles, init_fn, transition_fn, loglik_fn,
                move_fn=sir_move_fn(500), theta=theta,
                return_particles=False,
            )
        else:
            res = bootstrap_filter(
                key, ys, particles, init_fn, transition_fn, loglik_fn,
                theta=theta, return_particles=False,
            )
        return res.loglike

    return pf_loglike, prior_fns


def device_samples_per_sec(
    y, chains, particles, steps_per_call, timed_calls, reps, transition,
    config="bpf",
):
    import jax
    import jax.numpy as jnp
    from jax import lax

    from bayesssm_tpu.pmmh.priors import sum_log_priors

    pf_loglike, prior_fns = _build_pf_loglike(
        config, y, particles, transition
    )
    prop_sd = jnp.array(
        _PROP_SD.get(config, (0.1, 0.1)), dtype=jnp.float32
    )

    def mh_step(carry, _):
        key, theta, ll = carry
        key, k_prop, k_pf, k_acc = jax.random.split(key, 4)
        z = jnp.log(theta)
        zp = z + prop_sd * jax.random.normal(k_prop, z.shape, dtype=z.dtype)
        theta_prop = jnp.exp(zp)
        lp_prop = sum_log_priors(theta_prop, prior_fns)
        ll_prop = pf_loglike(k_pf, theta_prop)
        log_ratio = (ll_prop + lp_prop + zp.sum()) - (
            ll + sum_log_priors(theta, prior_fns) + z.sum()
        )
        log_ratio = jnp.where(jnp.isnan(log_ratio), -jnp.inf, log_ratio)
        accept = jnp.log(jax.random.uniform(k_acc)) < log_ratio
        theta = jnp.where(accept, theta_prop, theta)
        ll = jnp.where(accept, ll_prop, ll)
        return (key, theta, ll), None

    def k_steps(keys, thetas, lls):
        def one(key, theta, ll):
            (key, theta, ll), _ = lax.scan(
                mh_step, (key, theta, ll), None, length=steps_per_call
            )
            return key, theta, ll

        return jax.vmap(one)(keys, thetas, lls)

    keys = jax.random.split(jax.random.key(0), chains)
    thetas = jnp.tile(
        jnp.array(_THETA0.get(config, (0.5, 0.2)), jnp.float32),
        (chains, 1),
    )
    ll0 = jax.vmap(pf_loglike)(
        jax.random.split(jax.random.key(1), chains),
        thetas,
    )
    step = jax.jit(k_steps)

    # Warmup / compile.
    keys, thetas, lls = jax.block_until_ready(step(keys, thetas, ll0))

    # Median of `reps` timing repetitions: the data-dependent Gillespie
    # event counts make single runs noisy.
    rates = []
    samples_per_rep = chains * steps_per_call * timed_calls
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(timed_calls):
            keys, thetas, lls = step(keys, thetas, lls)
        jax.block_until_ready((keys, thetas, lls))
        rates.append(samples_per_rep / (time.perf_counter() - t0))
    return float(np.median(rates)), rates


def pmmh_e2e_samples_per_sec(y, chains, m, transition):
    """The public two-phase pmmh() driver on the SIR benchmark config.

    Pilot lengths are scaled down from the reference defaults (pilot_m
    2000 -> 200, reps 100 -> 20) to bound bench wall time; the sampling
    phase is the production chunked lax.scan driver unmodified.

    The reported rate is the MARGINAL sampling rate between a short run
    (m//8) and the full run: chains*(m - m//8) / (t_m - t_short). Each
    sampling phase pays one-off costs inside its timer (the first call of
    each compiled program), whatever m is, and the difference cancels
    them.
    Returns (marginal samples/s, timings dict of the full run with the
    short run's sampling time under "sampling_short", target_n stats).
    """
    import warnings

    from bayesssm_tpu.models.sir import sir_model, sir_sweep_pf_impl
    from bayesssm_tpu.pmmh.driver import pmmh
    from bayesssm_tpu.pmmh.tuning import default_tune_control

    # "sir_sweep" routes the whole filter through the whole-sweep kernel
    # via pf_impl; the model fns are then unused by the filter but still
    # required by the driver's signature validation.
    model_transition = (
        "gillespie" if transition == "sir_sweep" else transition
    )
    (init_fn, transition_fn, loglik_fn), log_priors, transform = sir_model(
        n_total=500, init_infected=70, transition=model_transition
    )
    pf_impl = (
        sir_sweep_pf_impl(500, 70) if transition == "sir_sweep" else None
    )

    def run(m_run):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return pmmh(
                "bootstrap_filter", np.asarray(y, np.float32), m_run,
                init_fn, transition_fn, loglik_fn, log_priors,
                pilot_init_params={"lam": 0.5, "gamma": 0.2},
                burn_in=m_run // 4, num_chains=chains, seed=1405,
                param_transform=transform,
                tune_control=default_tune_control(
                    pilot_m=200, pilot_burn_in=50, pilot_reps=20
                ),
                print_summary=False, pf_impl=pf_impl,
            )

    m_short = max(2, m // 8)
    # Each length runs TWICE and the MARGINAL rate uses the MIN sampling
    # time per length: a one-off cost that lands in only one of the two
    # runs would break the cancellation. Ordering full-m first keeps any
    # residual warm-cache advantage conservative. Raw timings of the used
    # runs stay in the returned dict so the cancellation is checkable.
    first = run(m)
    out = run(m)
    t_full = min(
        first.timings.get("sampling", float("nan")),
        out.timings.get("sampling", float("nan")),
    )
    t_short = min(
        run(m_short).timings.get("sampling", float("nan"))
        for _ in range(2)
    )
    rate = chains * (m - m_short) / (t_full - t_short)
    timings = dict(out.timings)
    timings["sampling"] = t_full
    timings["sampling_short"] = t_short
    return rate, timings, np.asarray(out.target_n)


def baseline_samples_per_sec(y, particles, steps, reps, config="bpf"):
    """Single-core samples/s: one MH step costs one PF sweep; timed at the
    generating parameters for run-to-run stability (MH exploration makes
    per-step cost noisy), which if anything flatters the baseline since
    proposals above the truth simulate more epidemic events. Median of
    ``reps`` repeats."""
    sys.path.insert(0, "baselines")
    import numpy as np

    from single_core_numpy import (
        sinusoidal_bpf_loglike,
        sir_apf_loglike,
        sir_bpf_loglike,
        sir_rmpf_loglike,
    )

    fn = {
        "bpf": sir_bpf_loglike,
        "pmmh": sir_bpf_loglike,
        "apf": sir_apf_loglike,
        "rmpf": sir_rmpf_loglike,
        "sinusoidal": sinusoidal_bpf_loglike,
    }[config]
    theta = (
        (0.8, 1.0, 0.5) if config == "sinusoidal" else (0.5, 0.2, 500, 70)
    )
    rng = np.random.default_rng(0)
    # warmup sweep
    fn(rng, y, particles, *theta)
    rates = []
    for _ in range(reps):
        t0 = time.time()
        for _ in range(steps):
            fn(rng, y, particles, *theta)
        rates.append(steps / (time.time() - t0))
    return float(np.median(rates))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--config", default="bpf", choices=CONFIGS)
    ap.add_argument("--chains", type=int, default=4096)
    ap.add_argument("--particles", type=int, default=128)
    # MH steps per jitted call: amortizes the per-call dispatch, matching
    # how production runs execute (the pmmh driver scans hundreds of
    # steps per chunk).
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--calls", type=int, default=2)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--m", type=int, default=512,
                    help="MH chain length for --config pmmh (the metric "
                         "is the marginal rate between m//8 and m)")
    ap.add_argument(
        "--transition", default="sir_sweep",
        choices=["gillespie", "tauleap", "sir_sweep"],
        help="SIR filter path (sir_sweep = the whole-sweep kernel, the "
             "default for every config; gillespie/tauleap = the plain "
             "engine with that transition)",
    )
    ap.add_argument("--baseline-steps", type=int, default=20)
    ap.add_argument("--baseline-reps", type=int, default=3)
    ap.add_argument(
        "--profile", metavar="DIR", default=None,
        help="write a jax.profiler trace of the timed region to DIR",
    )
    args = ap.parse_args()

    if args.quick:
        args.chains, args.steps, args.calls = 256, 2, 2
        args.baseline_steps, args.baseline_reps = 2, 1
        args.reps = 2
        args.m = 8

    import pathlib

    from bayesssm_tpu.utils.device import (
        card_name_and_power_limit,
        require_gpu,
        use_compile_cache,
    )

    use_compile_cache(pathlib.Path(__file__).parent)
    device = require_gpu()
    import jax

    device_info = {
        "platform": device.platform,
        "kind": device.device_kind,
        "count": len(jax.devices()),
        "card": card_name_and_power_limit(),
    }

    if args.config == "sinusoidal":
        # BASELINE.json config 1: README sinusoidal AR(1), T = 20.
        from bayesssm_tpu.models.sinusoidal import simulate_sinusoidal

        _, y = simulate_sinusoidal(seed=1405, t_val=20)
    else:
        from bayesssm_tpu.models.sir import simulate_sir

        _, y = simulate_sir(seed=1405)

    if args.profile:
        import jax

        profile_ctx = jax.profiler.trace(args.profile)
    else:
        import contextlib

        profile_ctx = contextlib.nullcontext()

    model_tag = "sinusoidal" if args.config == "sinusoidal" else "sir"
    metric = f"pmmh_samples_per_sec_{args.chains}chains_{model_tag}"
    if args.config == "pmmh":
        with profile_ctx:
            value, timings, target_n = pmmh_e2e_samples_per_sec(
                y, args.chains, args.m, args.transition
            )
        print(
            f"pmmh e2e timings: {timings}; target_n "
            f"min/med/max = {target_n.min()}/"
            f"{int(np.median(target_n))}/{target_n.max()}",
            file=sys.stderr,
        )
        metric += "_pmmh_e2e"
    else:
        with profile_ctx:
            value, rates = device_samples_per_sec(
                y, args.chains, args.particles, args.steps, args.calls,
                args.reps, args.transition, config=args.config,
            )
        print(
            f"reps (samples/s): {[round(r) for r in rates]}",
            file=sys.stderr,
        )
        if args.config not in ("bpf", "sinusoidal"):
            metric += f"_{args.config}"

    base = baseline_samples_per_sec(
        y, args.particles, args.baseline_steps, args.baseline_reps,
        config=args.config,
    )

    print(
        json.dumps(
            {
                "metric": metric,
                "value": round(value, 2),
                "unit": "samples/s",
                "vs_baseline": round(value / base, 2),
                "device": device_info,
            }
        )
    )


if __name__ == "__main__":
    main()
