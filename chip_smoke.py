"""Smoke run of the PMMH main path on an NVIDIA GPU.

    python chip_smoke.py              # one card: every phase below
    python chip_smoke.py --devices 4  # four cards: the sharded phase only

One card, in one process:

1. Device: JAX's first device must be a GPU (else exit non-zero); print
   its kind and count, and the card's name and power limit.
2. Compile: every whole-sweep Triton kernel alone at real widths (SIR
   BPF/APF/RMPF at 4096 chains x 128 particles and 512 x 1024, the
   sinusoidal and linear-Gaussian instances), with compile seconds.
3. Kernel against the plain reference: SIR and sinusoidal log-likelihood
   mean and variance against the plain engine (filters/core.py) at the
   same theta, the linear-Gaussian kernel's likelihood estimate against
   the exact Kalman value; 5 standard errors each. The linear-Gaussian
   kernel also against its own interpret run on the same keys. Times of both routes, in turns.
4. End to end through ``pmmh()``: SIR BPF/APF/RMPF at both widths and the
   reference's own sinusoidal run (T=20, m=500, 2 chains, seed 1405,
   default pilot tuning), on the plain engine and through the kernel's
   ``pf_impl``. Each prints its posterior table; the phase fails on a
   non-finite sample or when the two routes' posterior means differ by
   more than 5 Monte-Carlo standard errors.
5. The tests marked ``gpu`` (tests/conftest.py), in this process.

``--devices 4`` runs ``pmmh()`` on SIR at 4096 chains over a (4, 1) chain
mesh (plain route and kernel route), the particle-sharded filter on a
(2, 2) mesh against the exact Kalman value, and the same SIR jobs on one
card for comparison.

Every result line names what it measured; the last line is one JSON
object ``{"ok": true, "device": {...}}``. A failed check raises, so the
script exits non-zero without that line.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import time
import warnings

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
SIR_PARAMS = ["lam", "gamma"]
SIR_THETA = (0.5, 0.2)
WIDTHS = [(4096, 128), (512, 1024)]     # (chains, particles)
ALGORITHMS = {"BPF": "bootstrap_filter", "APF": "auxiliary_filter",
              "RMPF": "resample_move_filter"}


def log(*parts):
    print(*parts, flush=True)


def check(ok, what):
    if not ok:
        raise AssertionError(what)
    log("  ok:", what)


def sir_setup():
    from bayesssm_tpu.models.sir import (
        simulate_sir, sir_aux_log_likelihood_fn, sir_model, sir_move_fn,
    )

    (init_fn, trans_fn, loglik_fn), log_priors, transform = sir_model(500, 70)
    _, y = simulate_sir(seed=1405)
    model_fns = (init_fn, trans_fn, loglik_fn, sir_aux_log_likelihood_fn,
                 sir_move_fn(500))
    return np.asarray(y, np.float32), model_fns, log_priors, transform


def batched_pf(factory, y, model_fns, params, algorithm, chains, particles):
    """jit(vmap) of one pf_impl's filter over ``chains`` (key, theta)."""
    import jax
    import jax.numpy as jnp

    pf = factory(y, None, params, model_fns, None, algorithm, "SISAR",
                 "stratified", False, max_particles=particles)

    def run(keys, thetas):
        return jax.vmap(
            lambda k, th: pf(k, th, n=jnp.float32(particles))
        )(keys, thetas)

    return jax.jit(run)


def fixed_particles(factory, particles):
    """A pf_impl factory that ignores the tuned particle count and runs
    every filter with ``particles`` lanes."""
    def make(y, num_particles, param_names, model_fns, obs_times, algorithm,
             resample_algorithm, resample_fn, carry_weights,
             max_particles=None):
        pf = factory(y, particles, param_names, model_fns, obs_times,
                     algorithm, resample_algorithm, resample_fn,
                     carry_weights, max_particles=particles)
        return lambda key, theta_vec, n=None: pf(key, theta_vec, n=particles)

    return make


def compare(name, ll_a, ll_b, label_a, label_b):
    """Mean and variance of two log-likelihood samples within 5 standard
    errors (the variance's error from the sample's fourth moment)."""
    a = np.asarray(ll_a, np.float64)
    b = np.asarray(ll_b, np.float64)
    check(np.isfinite(a).all() and np.isfinite(b).all(),
          f"{name}: all log-likelihoods finite")
    se_mean = np.sqrt(a.var() / a.size + b.var() / b.size)

    def var_se(x):
        d = x - x.mean()
        return np.sqrt(max((d**4).mean() - x.var() ** 2, 0.0) / x.size)

    se_var = np.hypot(var_se(a), var_se(b))
    log(f"  {name}: mean {label_a} {a.mean():.5f} {label_b} {b.mean():.5f}"
        f" (se {se_mean:.5f}); var {label_a} {a.var():.5f} {label_b} "
        f"{b.var():.5f} (se {se_var:.5f})")
    check(abs(a.mean() - b.mean()) < 5 * se_mean,
          f"{name}: means agree within 5 standard errors")
    check(abs(a.var() - b.var()) < 5 * se_var,
          f"{name}: variances agree within 5 standard errors")


def against_kalman(name, ll, exact):
    """The likelihood estimate is unbiased, its log is not (Jensen):
    compare log(mean(exp(ll))) with the exact value, within 5 standard
    errors of that estimate (delta method)."""
    ll = np.asarray(ll, np.float64)
    check(np.isfinite(ll).all(), f"{name}: all log-likelihoods finite")
    w = np.exp(ll - ll.max())
    est = ll.max() + np.log(w.mean())
    se = w.std() / (w.mean() * np.sqrt(ll.size))
    log(f"  {name}: log mean likelihood {est:.5f} Kalman {exact:.5f} "
        f"(se {se:.5f}); mean log-likelihood {ll.mean():.5f}")
    check(abs(est - exact) < 5 * se,
          f"{name}: within 5 standard errors of Kalman")


def timed(fn, *args, reps=5):
    """Median seconds of ``reps`` calls ended by block_until_ready."""
    import jax

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


# ------------------------------------------------------------------ phases


def phase_compile_and_compare():
    """Phases 2 and 3: compile each kernel at real widths, then compare it
    with its plain reference and time both routes."""
    import jax
    import jax.numpy as jnp

    from bayesssm_tpu.models.lgss import simulate_lgss
    from bayesssm_tpu.models.sinusoidal import (
        simulate_sinusoidal, sinusoidal_model, sinusoidal_sweep_pf_impl,
    )
    from bayesssm_tpu.models.sir import sir_sweep_pf_impl
    from bayesssm_tpu.ops.lgss_sweep_pallas import (
        lgss_bpf_sweep, lgss_mv_bpf_sweep,
    )
    from bayesssm_tpu.pmmh.tuning import _make_pf_loglike
    from bayesssm_tpu.utils.kalman import kalman_loglik

    y, model_fns, _, _ = sir_setup()
    jobs = []   # (name, kernel fn, plain fn or None, args)
    for chains, particles in WIDTHS:
        keys = jax.random.split(jax.random.key(1), chains)
        thetas = jnp.tile(jnp.asarray(SIR_THETA, jnp.float32), (chains, 1))
        for algorithm in ALGORITHMS:
            jobs.append((
                f"sir-{algorithm}-{chains}x{particles}",
                batched_pf(sir_sweep_pf_impl(500, 70), y, model_fns,
                           SIR_PARAMS, algorithm, chains, particles),
                batched_pf(_make_pf_loglike, y, model_fns, SIR_PARAMS,
                           algorithm, chains, particles),
                (keys, thetas),
            ))
    _, y_sin = simulate_sinusoidal(seed=1405, t_val=20)
    sin_fns, _, _ = sinusoidal_model()
    sin_params = ["phi", "sigma_x", "sigma_y"]
    keys = jax.random.split(jax.random.key(2), 1024)
    thetas = jnp.tile(jnp.asarray([0.8, 1.0, 0.5], jnp.float32), (1024, 1))
    jobs.append((
        "sinusoidal-1024x512",
        batched_pf(sinusoidal_sweep_pf_impl(), y_sin, sin_fns + (None, None),
                   sin_params, "BPF", 1024, 512),
        batched_pf(_make_pf_loglike, y_sin, sin_fns + (None, None),
                   sin_params, "BPF", 1024, 512),
        (keys, thetas),
    ))
    a, sx, sy = 0.9, 0.6, 0.4
    _, y_lg = simulate_lgss(11, t_val=20, a=a, sigma_x=sx, sigma_y=sy)
    y_lg = jnp.asarray(y_lg, jnp.float32)
    keys = jax.random.split(jax.random.key(3), 1024)
    jobs.append((
        "lgss-1024x128",
        jax.jit(jax.vmap(lambda k: lgss_bpf_sweep(
            k, y_lg, 128, a, sx, sy, resample_algorithm="SISR"))),
        None, (keys,),
    ))
    y_mv = jnp.stack([y_lg, 0.5 * y_lg], axis=1)
    obs_times = np.arange(1, 41, 2)
    jobs.append((
        "lgss-mv-gapped-1024x128",
        jax.jit(jax.vmap(lambda k: lgss_mv_bpf_sweep(
            k, y_mv, 128, a, sx, (sy, sy), obs_times=obs_times,
            resample_algorithm="SISR"))),
        jax.jit(jax.vmap(lambda k: lgss_mv_plain(
            k, y_mv, 128, a, sx, sy, obs_times))),
        (keys,),
    ))

    log("== phase 2: compile each kernel at real widths")
    compiled = {}
    for name, kernel, _, args in jobs:
        t0 = time.perf_counter()
        compiled[name] = kernel.lower(*args).compile()
        log(f"  compile {name}: {time.perf_counter() - t0:.2f} s")

    log("== phase 3: kernels against the plain reference")
    for name, _, plain, args in jobs:
        ll_k, est_k = compiled[name](*args)
        check(np.isfinite(np.asarray(est_k)).all(),
              f"{name}: kernel state estimates finite")
        if plain is None:
            continue
        t0 = time.perf_counter()
        plain_c = plain.lower(*args).compile()
        log(f"  compile {name} plain: {time.perf_counter() - t0:.2f} s")
        ll_p, _ = plain_c(*args)
        compare(name, ll_k, ll_p, "kernel", "plain")
        times = {}
        for route in ("plain", "kernel", "kernel", "plain"):
            fn = compiled[name] if route == "kernel" else plain_c
            times.setdefault(route, []).append(timed(fn, *args))
        log(f"  time {name}: kernel {np.mean(times['kernel']) * 1e3:.3f} ms"
            f" plain {np.mean(times['plain']) * 1e3:.3f} ms per filter batch")
    name = "lgss-1024x128"
    exact = kalman_loglik(np.asarray(y_lg), a, 1.0, sx, sy, p0=1.0)
    args = next(j[3] for j in jobs if j[0] == name)
    ll = np.asarray(compiled[name](*args)[0], np.float64)
    against_kalman(name, ll, exact)
    # The same kernel under the Pallas interpreter draws the same bits;
    # the card's transcendentals differ from XLA's in the last bit, which
    # can move an ancestor at a CDF tie and send a chain elsewhere.
    ll_i = np.asarray(jax.jit(jax.vmap(lambda k: lgss_bpf_sweep(
        k, y_lg, 128, a, sx, sy, resample_algorithm="SISR",
        interpret=True)))(*args)[0], np.float64)
    agree_share = float(np.mean(np.abs(ll - ll_i) < 1e-3))
    log(f"  {name}: compiled vs interpret: {agree_share:.4f} of chains within"
        f" 1e-3, median |diff| {np.median(np.abs(ll - ll_i)):.2e}")
    check(agree_share >= 0.95,
          f"{name}: compiled agrees with interpret on >= 95% of chains")


def lgss_mv_plain(key, y, particles, a, sx, sy, obs_times):
    """The plain engine on the two-row linear-Gaussian model that
    ops/lgss_sweep_pallas.py::lgss_mv_bpf_sweep runs (c = (1, 0.5))."""
    import jax
    import jax.numpy as jnp

    from bayesssm_tpu.filters.bootstrap import bootstrap_filter

    def init_fn(key, num_particles):
        return jax.random.normal(key, (num_particles,))

    def transition_fn(key, particles):
        return a * particles + sx * jax.random.normal(key, particles.shape)

    def loglik_fn(y, particles):
        r1 = (y[0] - particles) / sy
        r2 = (y[1] - 0.5 * particles) / sy
        return (-0.5 * (r1 * r1 + r2 * r2) - 2.0 * jnp.log(sy)
                - jnp.log(2.0 * jnp.pi))

    res = bootstrap_filter(
        key, y, particles, init_fn, transition_fn, loglik_fn,
        obs_times=obs_times, resample_algorithm="SISR",
        return_particles=False,
    )
    return res.loglike, res.state_est


def posterior(out):
    """(mean, Monte-Carlo standard error) per parameter of a PMMH run.

    Chains are independent, so with many chains the error of the pooled
    mean comes from the spread of the chain means (valid even where a
    stuck chain makes ESS undefined); with few chains from sd / sqrt(ESS).
    """
    res = {}
    for p, chain in out.theta_chain.items():
        s = np.asarray(chain, np.float64)
        check(np.isfinite(s).all(), f"all samples of {p} finite")
        if s.shape[0] > 2:
            se = s.mean(axis=1).std(ddof=1) / np.sqrt(s.shape[0])
        else:
            ess = out.diagnostics["ess"][p]
            se = s.std() / np.sqrt(ess if np.isfinite(ess) else s.shape[0])
        res[p] = (s.mean(), se)
    return res


def agree(name, post_a, post_b):
    for p in post_a:
        (ma, sa), (mb, sb) = post_a[p], post_b[p]
        log(f"  {name} {p}: {ma:.5f} vs {mb:.5f} (mc se {np.hypot(sa, sb):.5f})")
        check(abs(ma - mb) < 5 * np.hypot(sa, sb),
              f"{name}: posterior means of {p} agree within 5 MC errors")


def run_pmmh(name, y, model_fns, log_priors, transform, algorithm, chains,
             m, burn_in, tune, pilot_init, pf_impl=None, mesh=None):
    from bayesssm_tpu.pmmh.driver import pmmh

    init_fn, trans_fn, loglik_fn, aux_fn, move_fn = model_fns
    log(f"-- pmmh {name}")
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out = pmmh(
            ALGORITHMS[algorithm], y, m, init_fn, trans_fn, loglik_fn,
            log_priors, pilot_init_params=pilot_init, burn_in=burn_in,
            num_chains=chains,
            aux_log_likelihood_fn=aux_fn if algorithm == "APF" else None,
            move_fn=move_fn if algorithm == "RMPF" else None,
            param_transform=transform, tune_control=tune, seed=1405,
            pf_impl=pf_impl, mesh=mesh, print_summary=True,
        )
    wall = time.perf_counter() - t0
    timings = {k: round(v, 3) for k, v in (out.timings or {}).items()}
    log(f"  wall {wall:.2f} s; phases {timings}; acceptance mean "
        f"{np.mean(out.acceptance_rate):.3f}; target_n min/max "
        f"{out.target_n.min()}/{out.target_n.max()}; chunk memory "
        f"{out.chunk_memory}")
    return out


def phase_pmmh():
    """Phase 4: pmmh() end to end, plain route against kernel route."""
    from bayesssm_tpu.models.sinusoidal import (
        simulate_sinusoidal, sinusoidal_model, sinusoidal_sweep_pf_impl,
    )
    from bayesssm_tpu.models.sir import sir_sweep_pf_impl
    from bayesssm_tpu.pmmh.tuning import _make_pf_loglike, default_tune_control

    log("== phase 4: pmmh() end to end")
    y, model_fns, log_priors, transform = sir_setup()
    tune = default_tune_control(pilot_m=50, pilot_burn_in=10, pilot_reps=10)
    pilot_init = {"lam": SIR_THETA[0], "gamma": SIR_THETA[1]}
    for chains, particles in WIDTHS:
        for algorithm in ALGORITHMS:
            posts = {}
            for route, factory in (("plain", _make_pf_loglike),
                                   ("kernel", sir_sweep_pf_impl(500, 70))):
                name = f"sir-{algorithm}-{chains}x{particles}-{route}"
                out = run_pmmh(
                    name, y, model_fns, log_priors, transform, algorithm,
                    chains, 100, 40, tune, pilot_init,
                    pf_impl=fixed_particles(factory, particles),
                )
                posts[route] = posterior(out)
            agree(f"sir-{algorithm}-{chains}x{particles}", posts["plain"],
                  posts["kernel"])

    sin_fns, sin_priors, sin_transform = sinusoidal_model()
    _, y_sin = simulate_sinusoidal(seed=1405, t_val=20)
    posts = {}
    for route, pf_impl in (("plain", None),
                           ("kernel", sinusoidal_sweep_pf_impl())):
        out = run_pmmh(
            f"sinusoidal-reference-run-{route}", y_sin,
            sin_fns + (None, None), sin_priors, sin_transform, "BPF", 2,
            500, 50,
            default_tune_control(pilot_m=2000, pilot_burn_in=500,
                                 pilot_reps=100),
            [{"phi": 0.4, "sigma_x": 0.4, "sigma_y": 0.4},
             {"phi": 0.8, "sigma_x": 0.8, "sigma_y": 0.8}],
            pf_impl=pf_impl,
        )
        posts[route] = posterior(out)
    agree("sinusoidal-reference-run", posts["plain"], posts["kernel"])


def phase_gpu_tests():
    """Phase 5: the tests marked gpu, in this process (one client)."""
    import pytest

    log("== phase 5: tests marked gpu")
    os.environ["BAYESSSM_GPU_TESTS"] = "1"
    rc = pytest.main([
        str(ROOT / "tests"), "-m", "gpu", "-n", "0", "-q",
        "-p", "no:cacheprovider", "-p", "no:randomly",
    ])
    check(rc == 0, f"gpu-marked tests pass (pytest exit code {rc})")


def phase_four_cards():
    """``--devices 4``: chain-sharded pmmh() and the particle-sharded
    filter over four cards, against the same jobs on one card."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from bayesssm_tpu.models.lgss import lgss_model, simulate_lgss
    from bayesssm_tpu.models.sir import sir_sweep_pf_impl
    from bayesssm_tpu.parallel.sharded import sharded_particle_filter
    from bayesssm_tpu.pmmh.tuning import default_tune_control
    from bayesssm_tpu.utils.kalman import kalman_loglik

    devices = jax.devices()
    check(len(devices) == 4, f"four devices ({len(devices)} found)")

    def memory():
        for d in devices:
            stats = d.memory_stats() or {}
            log(f"  {d}: bytes_in_use {stats.get('bytes_in_use')} "
                f"peak_bytes_in_use {stats.get('peak_bytes_in_use')}")

    log("== four cards: particle-sharded filter on a (2, 2) mesh")
    mesh22 = Mesh(np.asarray(devices).reshape(2, 2), ("chains", "particles"))
    (lg_init, lg_trans, lg_loglik), _, _ = lgss_model()
    a, sx, sy = 0.9, 0.6, 0.4
    _, y_lg = simulate_lgss(7, t_val=20, a=a, sigma_x=sx, sigma_y=sy)
    chains = 512
    theta = {k: jnp.full((chains,), v)
             for k, v in (("a", a), ("sigma_x", sx), ("sigma_y", sy))}
    ll, states = sharded_particle_filter(
        jax.random.key(3), y_lg, 1024, lg_init, lg_trans, lg_loglik, theta,
        num_chains=chains, mesh=mesh22, resample_algorithm="SISR",
    )
    ll = jax.block_until_ready(ll)
    log(f"  loglike sharding {ll.sharding}; states sharding {states.sharding}")
    against_kalman("particle-sharded filter", ll,
                   kalman_loglik(y_lg, a, 1.0, sx, sy))
    memory()

    log("== four cards: pmmh() on SIR, 4096 chains over a (4, 1) mesh")
    mesh41 = Mesh(np.asarray(devices).reshape(4, 1), ("chains", "particles"))
    y, model_fns, log_priors, transform = sir_setup()
    tune = default_tune_control(pilot_m=50, pilot_burn_in=10, pilot_reps=10)
    pilot_init = {"lam": SIR_THETA[0], "gamma": SIR_THETA[1]}
    for route, pf_impl in (("plain", None),
                           ("kernel", sir_sweep_pf_impl(500, 70))):
        posts = {}
        for layout, mesh in (("4-cards", mesh41), ("1-card", None)):
            out = run_pmmh(
                f"sir-BPF-4096-{route}-{layout}", y, model_fns, log_priors,
                transform, "BPF", 4096, 100, 40, tune, pilot_init,
                pf_impl=pf_impl, mesh=mesh,
            )
            posts[layout] = posterior(out)
            memory()
        agree(f"sir-BPF-4096-{route} 4 cards vs 1", posts["4-cards"],
              posts["1-card"])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, choices=(1, 4), default=1,
                    help="4 runs only the sharded phase on four cards")
    args = ap.parse_args()

    sys.path.insert(0, str(ROOT))
    from bayesssm_tpu.utils.device import (
        card_name_and_power_limit, require_gpu, use_compile_cache,
    )

    import jax

    use_compile_cache(ROOT)
    device = require_gpu()
    count = len(jax.devices())
    log("== phase 1: device")
    log(f"  platform {device.platform}; device_kind {device.device_kind}; "
        f"devices {count}")
    log(f"  card (name, power limit): {card_name_and_power_limit()}")
    t0 = time.perf_counter()
    if args.devices == 4:
        phase_four_cards()
    else:
        phase_compile_and_compare()
        phase_pmmh()
        phase_gpu_tests()
    log(f"== all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": device.platform, "kind": device.device_kind,
        "count": count,
    }}))


if __name__ == "__main__":
    main()
