"""Particle Marginal Metropolis-Hastings driver.

Re-design of /root/reference/R/pmmh.R:243-630 for JAX. The reference
runs one serial R process per chain; here every chain is a lane of a
``vmap`` over ``[num_chains]`` arrays, the MH loop is a ``lax.scan`` whose
body runs a full particle-filter scan, and the chains axis can be sharded
across a device mesh. Execution happens in two jitted phases with one host
sync between them:

  phase 1 (tuning)  — per-chain pilot RWM chain + pilot variance run
                      (R/pmmh.R:345-389, R/pmmh_tuning.R), vmapped.
  host sync         — the tuned per-chain particle counts (Q9) are pulled to
                      the host; the static particle-lane bound for phase 2 is
                      the max count rounded up to the next power of two
                      (the whole-sweep kernel's block width; masked lanes make
                      each chain use exactly its own target_n).
  phase 2 (sampling)— the m-step MH loop (R/pmmh.R:422-500), vmapped.

Matching reference semantics: MVN proposals in transformed space with the
delta-method covariance `J cov(theta) J^T` built from the *untransformed*
pilot covariance (Q6, R/pmmh.R:377-389); a proposal outside the prior
support counts as a rejection (unlike the pilot chain's re-propose loop,
Q7); NaN acceptance ratios force rejection (R/pmmh.R:488-490); per-chain
tuning (Q9). Differences (documented): the PF is evaluated even for
out-of-support proposals (branchless select instead of `next`), and chain
RNG derives from fold_in(key, chain_index) so results are independent of
mesh layout — the analogue of the reference's scheduling-independent
per-chain seeds (R/pmmh.R:511, tested in test-pmmh.R:468-503).
"""

from __future__ import annotations

import warnings
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from bayesssm_tpu.diagnostics.ess import ess_matrix
from bayesssm_tpu.diagnostics.rhat import rhat_matrix
from bayesssm_tpu.output import PMMHOutput
from bayesssm_tpu.pmmh.priors import sum_log_priors
from bayesssm_tpu.pmmh.transforms import (
    back_transform_params,
    log_jacobian,
    resolve_transforms,
    transform_params,
)
from bayesssm_tpu.pmmh.tuning import (
    TuneControl,
    _make_pf_loglike,
    _particle_lane_bound,
    default_tune_control,
    run_pilot_chain,
)
from bayesssm_tpu.utils.signatures import check_params_match

__all__ = ["pmmh"]

_ALGO_BY_NAME = {
    "bootstrap_filter": "BPF",
    "auxiliary_filter": "APF",
    "resample_move_filter": "RMPF",
    "BPF": "BPF",
    "APF": "APF",
    "RMPF": "RMPF",
}


def _resolve_algorithm(pf_wrapper) -> str:
    """Accept a filter callable, its name, or an algorithm code."""
    if pf_wrapper is None:
        return "BPF"
    name = pf_wrapper if isinstance(pf_wrapper, str) else getattr(
        pf_wrapper, "__name__", str(pf_wrapper)
    )
    if name not in _ALGO_BY_NAME:
        raise ValueError(
            "pf_wrapper must be bootstrap_filter, auxiliary_filter, "
            "resample_move_filter (or 'BPF'/'APF'/'RMPF')"
        )
    return _ALGO_BY_NAME[name]


def _stack_init_params(pilot_init_params, num_chains, param_names):
    """Validate and stack per-chain initial parameters to [chains, P].

    Mirrors R/pmmh.R:273-279: a list with one entry per chain, all entries
    sharing the same parameter names; a single dict is broadcast.
    """
    if isinstance(pilot_init_params, dict):
        pilot_init_params = [pilot_init_params] * num_chains
    if len(pilot_init_params) != num_chains:
        raise ValueError(
            "pilot_init_params must have one entry per chain "
            f"(got {len(pilot_init_params)}, num_chains={num_chains})"
        )
    names0 = set(pilot_init_params[0])
    for entry in pilot_init_params[1:]:
        if set(entry) != names0:
            raise ValueError(
                "pilot_init_params entries must share the same parameter names"
            )
    if len(names0) == 0:
        raise ValueError("pilot_init_params must contain at least one parameter.")
    missing = [p for p in param_names if p not in names0]
    if missing:
        raise ValueError(
            "Parameters in functions do not match the names in pilot_init_params"
        )
    return np.array(
        [[float(entry[p]) for p in param_names] for entry in pilot_init_params],
        dtype=np.float32,
    )


def _proposal_factor(cov: np.ndarray) -> np.ndarray:
    """PSD-tolerant factor L with L L^T = cov (eigen-based, like
    MASS::mvrnorm's eigendecomposition proposal)."""
    cov = 0.5 * (cov + cov.T)
    eigval, eigvec = np.linalg.eigh(cov)
    eigval = np.clip(eigval, 0.0, None)
    return (eigvec * np.sqrt(eigval)[None, :]).astype(np.float32)


def pmmh(
    pf_wrapper,
    y,
    m: int,
    init_fn,
    transition_fn,
    log_likelihood_fn,
    log_priors: dict,
    pilot_init_params,
    burn_in: int,
    num_chains: int = 4,
    aux_log_likelihood_fn=None,
    move_fn=None,
    obs_times=None,
    resample_algorithm: str = "SISAR",
    resample_fn: str = "stratified",
    param_transform: Optional[dict] = None,
    tune_control: Optional[TuneControl] = None,
    verbose: bool = False,
    return_latent_state_est: bool = False,
    seed=None,
    jacobian_convention: str = "consistent",
    carry_weights: bool = False,
    mesh=None,
    chain_axis: str = "chains",
    particle_axis: str = "particles",
    print_summary: bool = True,
    checkpoint_every: Optional[int] = None,
    checkpoint_path=None,
    resume: bool = False,
    pf_impl=None,
    progress_every: Optional[int] = None,
) -> PMMHOutput:
    """Run PMMH with pilot tuning; returns a PMMHOutput.

    Arguments mirror the reference's pmmh() (/root/reference/R/pmmh.R:243);
    ``seed`` may be an int or a jax PRNG key. ``mesh`` optionally shards the
    chains axis over devices (jax.sharding.Mesh with a ``chain_axis`` axis).
    If the mesh also has a ``particle_axis`` axis of size > 1, the PARTICLE
    dimension of every filter evaluation (pilot tuning and sampling alike)
    is sharded over it: both phases then run inside ``shard_map`` and the
    filter completes its weight normalization/ESS with ``pmax``/``psum``
    and resamples via the distributed inverse-CDF path
    (ops.resampling.sharded_resample_indices), preserving the unsharded
    likelihood estimator exactly. This is the chains x particles scale-out
    the reference approximates with one process per chain
    (/root/reference/R/pmmh.R:512-531). Results for a fixed key are
    bit-reproducible for a fixed mesh layout and statistically invariant
    across layouts (per-shard model streams derive from
    fold_in(key, shard_index)).
    ``checkpoint_every``/``checkpoint_path`` periodically snapshot sampler
    state (utils/checkpoint.py); ``resume=True`` continues from an existing
    snapshot at ``checkpoint_path`` (tuning is skipped — the tuned proposal
    and particle counts are restored from the snapshot). On a
    process-spanning mesh each process allgathers the chain-sharded carry
    and writes an identical full snapshot, so a preempted multi-host run
    resumes from any surviving host and bit-matches an uninterrupted run
    with the same chunking (tests/test_distributed.py).

    ``progress_every`` sets the sampling chunk length for live progress
    reporting: after each chunk the driver prints step count and
    chunk/cumulative acceptance rates across chains — the streaming
    analogue of the reference's per-chain ``message()`` progress
    (/root/reference/R/pmmh.R:347-352). Defaults to min(500, m) when
    ``verbose=True``, off otherwise. Note the chunk layout is part of the
    bit-reproducibility contract (like ``checkpoint_every``): different
    chunkings compile different scans whose ULP-level reduction orders may
    flip individual MH accepts; results for a fixed (key, layout,
    chunking) are exactly reproducible. When neither checkpointing nor
    progress reporting is requested, the driver runs a fixed chunk
    pipeline whose sample outputs copy device->host asynchronously
    behind the next chunk's compute (and are trimmed to the post-burn-in
    region on device), so the sample transfer overlaps compute. Every
    chunk program is compiled AHEAD of the sampling loop (the
    ``"compile"`` entry in ``result.timings``), so the ``"sampling"``
    phase runs executables only and its throughput is the steady-state
    rate.

    ``pf_impl`` optionally replaces the generic filter evaluator in BOTH
    phases with a custom one sharing ``_make_pf_loglike``'s signature and
    returning ``pf(key, theta_vec, n=...) -> (loglike, state_est)`` — the
    analogue of the reference's "rewrite your model in Rcpp" escape hatch
    (detailed-overview.Rmd:401-470): e.g.
    ``models/sir.py::sir_sweep_pf_impl`` routes the whole sweep through one
    Pallas kernel (ops/sweep_builder.py). The evaluator must match the requested algorithm/
    resampling semantics (distributionally) — it is trusted, not checked.
    """
    # ---------------- validation (R/pmmh.R:263-322) ----------------
    if not isinstance(m, (int, np.integer)) or m < 1:
        raise ValueError("m must be an integer >= 1")
    if not isinstance(burn_in, (int, np.integer)) or not (0 <= burn_in <= m - 1):
        raise ValueError("burn_in must be an integer in [0, m - 1]")
    if not isinstance(num_chains, (int, np.integer)) or num_chains < 1:
        raise ValueError("num_chains must be an integer >= 1")
    if not isinstance(log_priors, dict) or len(log_priors) == 0:
        raise ValueError("log_priors must be a non-empty dict of callables")
    y_host = np.asarray(y)
    if not np.issubdtype(y_host.dtype, np.number) or np.isnan(y_host).any():
        # assert_numeric(y, any.missing = FALSE), R/pmmh.R:263.
        raise ValueError("y must be numeric with no missing values")

    algorithm = _resolve_algorithm(pf_wrapper)
    if algorithm == "APF" and aux_log_likelihood_fn is None:
        raise ValueError("APF requires aux_log_likelihood_fn")
    if algorithm == "RMPF" and move_fn is None:
        raise ValueError("RMPF requires a move_fn")

    param_names = list(log_priors.keys())
    prior_fns = [log_priors[p] for p in param_names]
    init_names = (
        pilot_init_params
        if isinstance(pilot_init_params, dict)
        else pilot_init_params[0]
    )
    check_params_match(
        init_fn, transition_fn, log_likelihood_fn, init_names, log_priors
    )
    theta0 = _stack_init_params(pilot_init_params, num_chains, param_names)

    transforms = resolve_transforms(param_transform, param_names)
    tune_control = tune_control or default_tune_control()

    # Initial parameters must lie inside the prior support
    # (R/pmmh_tuning.R:135-143).
    for c in range(num_chains):
        for j, fn in enumerate(prior_fns):
            if not np.isfinite(float(fn(jnp.asarray(theta0[c, j])))):
                raise ValueError(
                    "Initial parameter values are invalid: some lie outside "
                    "the prior support. Please provide valid starting values "
                    "via pilot_init_params."
                )

    # ---------------- keys ----------------
    if seed is None:
        seed = int(np.random.SeedSequence().generate_state(1)[0])
    if isinstance(seed, (int, np.integer)):
        root_key = jax.random.key(int(seed))
        seed_out = int(seed)
    else:
        root_key = seed
        seed_out = None
    # Per-chain keys derive from fold_in(root_key, chain_id) INSIDE the
    # jitted phases (phases take the chain-id vector, not a key array):
    # key arrays produced on the host are committed to a local device and
    # cannot be re-laid-out onto a process-spanning mesh, while the id
    # vector shards like any other per-chain input. Same bits either way.
    chain_ids = jnp.arange(num_chains)

    model_fns = (
        init_fn, transition_fn, log_likelihood_fn,
        aux_log_likelihood_fn, move_fn,
    )
    ys = jnp.asarray(y)

    ps = 1
    multiprocess = False
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        chain_sharding = NamedSharding(mesh, P(chain_axis))
        ps = int(dict(mesh.shape).get(particle_axis, 1))
        multiprocess = any(
            d.process_index != jax.process_index()
            for d in mesh.devices.flat
        )
        if not multiprocess:
            chain_ids = jax.device_put(chain_ids, chain_sharding)
            theta0 = jax.device_put(jnp.asarray(theta0), chain_sharding)
        if ps > 1 and pf_impl is not None:
            raise ValueError(
                "pf_impl evaluators are single-shard; use a mesh whose "
                f"'{particle_axis}' axis has size 1"
            )

    # Phases run inside shard_map when (a) the particle axis is sharded
    # (the filter core then completes its reductions collectively), or
    # (b) a pf_impl kernel evaluator is combined with a mesh — Pallas
    # kernels have no SPMD partitioning rules, so only manual sharding
    # keeps each shard's kernel local to its devices (XLA would otherwise
    # gather the chains axis onto one device).
    use_shard_map = mesh is not None and (ps > 1 or pf_impl is not None)
    if use_shard_map and num_chains % int(dict(mesh.shape)[chain_axis]):
        raise ValueError(
            "num_chains must be divisible by the mesh chains axis when "
            "the particle axis is sharded or a pf_impl is used with a mesh"
        )

    if ps > 1:
        import functools as _ft

        pf_factory = _ft.partial(
            _make_pf_loglike,
            particle_axis=particle_axis,
            particle_axis_size=ps,
        )
    else:
        pf_factory = pf_impl or _make_pf_loglike

    if use_shard_map:
        from jax import shard_map as _shard_map

        def _wrap_phase(fn, n_in):
            return jax.jit(
                _shard_map(
                    fn,
                    mesh=mesh,
                    in_specs=(P(chain_axis),) * n_in,
                    out_specs=P(chain_axis),
                    check_vma=False,
                )
            )
    elif multiprocess:
        # Host inputs (numpy / uncommitted) enter sharded over the global
        # mesh via in_shardings; every output is a per-chain array and
        # leaves chain-sharded.
        def _wrap_phase(fn, n_in):
            return jax.jit(
                fn,
                in_shardings=(chain_sharding,) * n_in,
                out_shardings=chain_sharding,
            )
    else:
        def _wrap_phase(fn, n_in):
            return jax.jit(fn)

    # Host fetch: identical to np.asarray on one process; when the mesh
    # spans OS processes (multi-controller SPMD, parallel/distributed.py)
    # device outputs are chain-sharded global arrays that no single
    # process fully addresses, so host syncs go through a process
    # all-gather — every process then holds the identical full result,
    # the lift of the reference's per-worker chain collection
    # (/root/reference/R/pmmh.R:512-531).
    if multiprocess:
        from jax.experimental import multihost_utils

        def _fetch(x):
            if getattr(x, "is_fully_addressable", True):
                return np.asarray(x)
            return np.asarray(
                multihost_utils.process_allgather(x, tiled=True)
            )
    else:
        _fetch = np.asarray

    # ---------------- resume path ----------------
    resume_state = None
    if resume:
        import pathlib

        from bayesssm_tpu.utils.checkpoint import load_checkpoint

        if checkpoint_path is None or not pathlib.Path(checkpoint_path).exists():
            raise ValueError(
                "resume=True requires an existing checkpoint_path"
            )
        resume_state = load_checkpoint(checkpoint_path)
        if verbose:
            print(
                f"Resuming from {checkpoint_path} at step "
                f"{resume_state['step']}/{m}"
            )

    # ---------------- phase 1: pilot tuning (vmapped over chains) -------
    if verbose and resume_state is None:
        print(f"Running pilot chains for tuning ({num_chains} chains)...")

    def tuning_phase(cid, th0):
        key = jax.random.fold_in(root_key, cid)
        return run_pilot_chain(
            key, ys, param_names, model_fns, prior_fns, th0, transforms,
            tune_control, obs_times=obs_times, algorithm=algorithm,
            jacobian_convention=jacobian_convention,
            carry_weights=carry_weights, pf_impl=pf_factory,
        )

    from bayesssm_tpu.utils.timing import PhaseTimer

    timer = PhaseTimer(verbose=verbose)

    if resume_state is None:
        with timer.phase("tuning"):
            tuned = _wrap_phase(jax.vmap(tuning_phase), 2)(
                chain_ids, jnp.asarray(theta0)
            )
            jax.block_until_ready(tuned["target_n"])
        theta_mean = _fetch(tuned["pilot_theta_mean"]).astype(np.float64)
        theta_cov = _fetch(tuned["pilot_theta_cov"]).astype(np.float64)
        target_n = _fetch(tuned["target_n"]).astype(np.int64)

        if verbose:
            for c in range(num_chains):
                print(f"Chain {c + 1}: pilot posterior mean {theta_mean[c]}")
                print(f"Chain {c + 1}: pilot covariance\n{theta_cov[c]}")
            print(f"Using {target_n} particles for PMMH:")

        # Delta-method proposal covariance in z-space (Q6, R/pmmh.R:377-389).
        prop_factors = np.zeros_like(theta_cov, dtype=np.float32)
        for c in range(num_chains):
            scale = np.ones(len(param_names))
            for j, t in enumerate(transforms):
                if t == "log":
                    scale[j] = 1.0 / theta_mean[c, j]
                elif t == "logit":
                    scale[j] = 1.0 / (
                        theta_mean[c, j] * (1.0 - theta_mean[c, j])
                    )
            cov_z = (scale[:, None] * theta_cov[c]) * scale[None, :]
            prop_factors[c] = _proposal_factor(cov_z)
    else:
        theta_mean = np.asarray(resume_state["meta"]["theta_mean"])
        target_n = np.asarray(resume_state["meta"]["target_n"], dtype=np.int64)
        prop_factors = np.asarray(
            resume_state["meta"]["prop_factors"], dtype=np.float32
        )

    # Static particle-lane bound (see _particle_lane_bound).
    max_particles = _particle_lane_bound(int(target_n.max()))

    # ---------------- phase 2: main PMMH chains (chunked) ----------------
    pf = pf_factory(
        ys, None, param_names, model_fns, obs_times, algorithm,
        resample_algorithm, resample_fn, carry_weights,
        max_particles=max_particles,
    )
    p = len(param_names)

    def mh_step(key, theta, ll, se, factor, n_chain):
        key, k_prop, k_pf, k_acc = jax.random.split(key, 4)
        z = transform_params(theta, transforms)
        # TF32 would round the proposal step to about three digits.
        zp = z + jnp.matmul(
            factor, jax.random.normal(k_prop, (p,), dtype=z.dtype),
            precision="highest",
        )
        theta_prop = back_transform_params(zp, transforms)
        lp_prop = sum_log_priors(theta_prop, prior_fns)
        ll_prop, se_prop = pf(k_pf, theta_prop, n=n_chain)
        if not return_latent_state_est:
            # The state-estimate trajectory is pure payload — it never
            # feeds back into the chain. When it is not requested, carry
            # a scalar dummy so XLA dead-code-eliminates the whole
            # [T+1, d] consumer chain (the per-step accept-select and
            # the scan-carry copies). Derived from ll_prop (not a fresh constant) so it inherits the
            # chains sharding under a mesh.
            se_prop = ll_prop * 0.0
        log_ratio = (
            ll_prop + lp_prop
            + log_jacobian(theta_prop, transforms, jacobian_convention)
        ) - (
            ll + sum_log_priors(theta, prior_fns)
            + log_jacobian(theta, transforms, jacobian_convention)
        )
        # NaN or out-of-support proposal -> forced rejection
        # (R/pmmh.R:435-442, :488-490).
        log_ratio = jnp.where(
            jnp.isnan(log_ratio) | ~jnp.isfinite(lp_prop), -jnp.inf, log_ratio
        )
        accept = jnp.log(jax.random.uniform(k_acc)) < log_ratio
        theta = jnp.where(accept, theta_prop, theta)
        ll = jnp.where(accept, ll_prop, ll)
        se = jnp.where(accept, se_prop, se)
        return key, theta, ll, se, accept

    def _init_eval(cids, th_means, n_chains):
        def one(cid, th, n):
            key = jax.random.fold_in(root_key, cid)
            key, k0 = jax.random.split(key)
            ll0, se0 = pf(k0, th.astype(jnp.float32), n=n)
            if not return_latent_state_est:
                se0 = ll0 * 0.0  # sharding-inheriting dummy (see mh_step)
            return key, th.astype(jnp.float32), ll0, se0

        return jax.vmap(one)(cids, th_means, n_chains)

    init_eval = _wrap_phase(_init_eval, 3)

    from functools import lru_cache

    @lru_cache(maxsize=None)
    def chunk_fn(length: int, emit: bool = True):
        """``emit=False`` compiles a burn-in variant whose scan carries
        only (keys, theta, ll, se) and outputs per-step ACCEPTS alone —
        no per-step theta/state-estimate writes for samples the burn-in
        would discard anyway."""

        def chunk(keys, thetas, lls, ses, factors, n_chains):
            def one(key, theta, ll, se, factor, n_chain):
                def step(carry, _):
                    key, theta, ll, se = carry
                    key, theta, ll, se, accept = mh_step(
                        key, theta, ll, se, factor, n_chain
                    )
                    if not emit:
                        return (key, theta, ll, se), (accept,)
                    out = (theta, se) if return_latent_state_est else (theta,)
                    return (key, theta, ll, se), out + (accept,)

                (key, theta, ll, se), outs = lax.scan(
                    step, (key, theta, ll, se), None, length=length
                )
                return (key, theta, ll, se), outs

            return jax.vmap(one)(keys, thetas, lls, ses, factors, n_chains)

        return _wrap_phase(chunk, 6)

    if verbose:
        print("Running Particle MCMC chains with tuned settings...")

    n_chain_arr = jnp.asarray(target_n, dtype=jnp.float32)
    factors = jnp.asarray(prop_factors)
    th_means = jnp.asarray(theta_mean, dtype=jnp.float32)
    if mesh is not None and not multiprocess:
        n_chain_arr = jax.device_put(n_chain_arr, chain_sharding)
        factors = jax.device_put(factors, chain_sharding)
        th_means = jax.device_put(th_means, chain_sharding)

    if resume_state is None:
        cur_keys, cur_theta, cur_ll, cur_se = init_eval(
            chain_ids, th_means, n_chain_arr
        )
        theta_samples = [_fetch(cur_theta)[:, None, :]]  # [C, 1, P]
        state_samples = (
            [_fetch(cur_se)[:, None]] if return_latent_state_est else None
        )
        accept_total = np.zeros(num_chains)
        steps_done = 1
    else:
        cur_keys = resume_state["keys"]
        cur_theta = jnp.asarray(resume_state["theta"])
        cur_ll = jnp.asarray(resume_state["loglike"])
        cur_se = jnp.asarray(resume_state["state_est"])
        # A snapshot records latent-state history only when the run that
        # wrote it collected it; resuming with a DIFFERENT
        # return_latent_state_est cannot reconstruct the missing history
        # (and the carried state_est aval would disagree with the new
        # program). Reject the flag flip explicitly instead of failing
        # deep inside the scan trace.
        if return_latent_state_est and "state_samples" not in resume_state:
            raise ValueError(
                "resume=True with return_latent_state_est=True, but the "
                "checkpoint was written without latent-state collection; "
                "resume with return_latent_state_est=False or restart"
            )
        if not return_latent_state_est:
            # The sampling carry uses a scalar dummy in this mode
            # (mh_step); drop any full state_est a True-mode snapshot
            # stored so the carry aval matches.
            cur_se = cur_ll * 0.0
        theta_samples = [np.asarray(resume_state["samples"])]
        state_samples = (
            [np.asarray(resume_state["state_samples"])]
            if return_latent_state_est and "state_samples" in resume_state
            else ([] if return_latent_state_est else None)
        )
        accept_total = np.asarray(
            resume_state["meta"].get("accept_total", np.zeros(num_chains))
        ).copy()
        steps_done = resume_state["step"]

    if progress_every is None and verbose:
        progress_every = min(500, m)
    # Fast path (no per-chunk host work requested): pipeline the sampling
    # scan in chunks whose outputs start their device->host copies
    # asynchronously while the NEXT chunk computes, so the final
    # np.asarray finds most bytes already on the host. Nothing is synced
    # inside the loop (acceptance sums stay on device), so the device
    # queue never drains between chunks. Chunk layout is part of the
    # bit-reproducibility contract (see docstring); this default is fixed
    # per version.
    fast_path = checkpoint_path is None and progress_every is None
    # The chunk schedule is a list of (length, emit) pairs. On the fast
    # path the FIRST chunk is aligned to the burn-in boundary and
    # compiled WITHOUT theta/state-estimate scan outputs (emit=False —
    # burned samples are never written); the post-burn-in remainder runs
    # in 256-step emitting chunks.
    schedule = []
    s = steps_done
    if fast_path:
        burned = max(0, min(burn_in - s, m - s))
        if burned > 0:
            schedule.append((burned, False))
            s += burned
        while s < m:
            ln = min(256, m - s)
            schedule.append((ln, True))
            s += ln
    else:
        chunk_size = (
            checkpoint_every or progress_every or (m - steps_done) or 1
        )
        while s < m:
            ln = min(chunk_size, m - s)
            schedule.append((ln, True))
            s += ln

    def _async_to_host(tree):
        for leaf in jax.tree_util.tree_leaves(tree):
            try:
                leaf.copy_to_host_async()
            except (AttributeError, RuntimeError):
                pass  # non-addressable shards fetch via _fetch instead

    # Ahead-of-time compile every chunk length the schedule will use,
    # OUTSIDE the sampling timer: each distinct length is its own XLA
    # program, and its compile (or persistent-cache load) would otherwise
    # land inside the first chunk that uses it — the sampling phase then
    # runs executables only and its throughput is the steady-state number.
    chunk_args = (cur_keys, cur_theta, cur_ll, cur_se, factors, n_chain_arr)
    compiled_chunks = {}
    with timer.phase("compile"):
        for length, emit in schedule:
            if (length, emit) not in compiled_chunks:
                compiled_chunks[(length, emit)] = (
                    chunk_fn(length, emit).lower(*chunk_args).compile()
                )
    # Device memory the longest chunk program needs (XLA's own account).
    stats = (
        compiled_chunks[max(compiled_chunks)].memory_analysis()
        if compiled_chunks else None
    )
    chunk_memory = None if stats is None else {
        f: int(getattr(stats, f)) for f in (
            "argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes",
        )
    }

    pending_accepts = []
    sampling_timer = timer.phase("sampling")
    sampling_timer.__enter__()
    for length, emit in schedule:
        (cur_keys, cur_theta, cur_ll, cur_se), outs = compiled_chunks[
            (length, emit)
        ](cur_keys, cur_theta, cur_ll, cur_se, factors, n_chain_arr)
        if not emit:
            (accepts,) = outs
            thetas = None
            ses = None
        elif return_latent_state_est:
            thetas, ses, accepts = outs
        else:
            thetas, accepts = outs
            ses = None
        steps_done += length
        if not emit:
            # Burn-in chunk: only the acceptance counts leave the device.
            accepts = jnp.sum(accepts, axis=1)
            _async_to_host(accepts)
            pending_accepts.append(accepts)
            continue
        if fast_path:
            # Only the post-burn-in slice ever reaches the host output
            # (checkpointing is off, so nothing needs the burned prefix);
            # slicing on DEVICE trims the transfer before it starts.
            # NOTE: with the burn-aligned schedule above, emitting chunks
            # always start at/after the burn-in boundary, so keep_from is
            # <= 0 here; the trim is kept as defense in depth should the
            # schedule ever change.
            keep_from = burn_in - (steps_done - length)
            if keep_from >= length:
                thetas = None
                ses = None
            elif keep_from > 0:
                thetas = thetas[:, keep_from:]
                ses = ses[:, keep_from:] if ses is not None else None
            accepts = jnp.sum(accepts, axis=1)
            _async_to_host((thetas, ses, accepts))
            theta_samples.append(thetas)
            if return_latent_state_est:
                state_samples.append(ses)
            pending_accepts.append(accepts)
            continue

        if return_latent_state_est:
            state_samples.append(_fetch(ses))  # [C, length, T+1(, d)]
        theta_samples.append(_fetch(thetas))
        accept_total += _fetch(jnp.sum(accepts, axis=1))
        if verbose:
            # Live progress (R/pmmh.R:347-352 analogue): step counter plus
            # acceptance over this chunk and cumulatively, across chains.
            chunk_acc = float(np.mean(_fetch(accepts)))
            cum_acc = float(accept_total.mean()) / max(steps_done - 1, 1)
            print(
                f"Sampling: {steps_done}/{m} steps — acceptance "
                f"chunk {chunk_acc:.3f}, cumulative {cum_acc:.3f}"
            )

        if checkpoint_path is not None:
            from bayesssm_tpu.utils.checkpoint import save_checkpoint

            # Snapshot the GLOBAL sampler state on the host: on a
            # process-spanning mesh the live carry is chain-sharded and
            # not fully addressable by any single process, so each
            # process allgathers it (via _fetch) and writes an identical
            # full snapshot — any surviving host can then resume, and
            # the resumed inputs re-shard through the jitted phases'
            # in_shardings exactly like the initial host inputs.
            keys_host = jax.random.wrap_key_data(
                _fetch(jax.random.key_data(cur_keys))
            )
            save_checkpoint(
                checkpoint_path,
                keys=keys_host,
                theta=_fetch(cur_theta),
                loglike=_fetch(cur_ll),
                state_est=_fetch(cur_se),
                samples=np.concatenate(theta_samples, axis=1),
                state_samples=(
                    np.concatenate(state_samples, axis=1)
                    if return_latent_state_est else None
                ),
                step=steps_done,
                meta={
                    "theta_mean": theta_mean,
                    "target_n": target_n,
                    "prop_factors": prop_factors,
                    "accept_total": accept_total,
                },
            )

    if fast_path:
        # The initial sample (global chain index 0) obeys the same
        # burn-in rule as the sliced chunks.
        if burn_in >= 1:
            theta_samples = theta_samples[1:]
            if return_latent_state_est:
                state_samples = state_samples[1:]
        theta_samples = [
            _fetch(t) for t in theta_samples if t is not None
        ]
        if return_latent_state_est:
            state_samples = [
                _fetch(s) for s in state_samples if s is not None
            ]
        for a in pending_accepts:
            accept_total += _fetch(a)
    sampling_timer.__exit__(None, None, None)
    theta_chains = np.concatenate(theta_samples, axis=1)
    state_chains = (
        np.concatenate(state_samples, axis=1)
        if return_latent_state_est else None
    )
    accept_rates = accept_total / max(m - 1, 1)

    # ---------------- post-processing (R/pmmh.R:540-627) ----------------
    # Fast path arrays were already trimmed to the post-burn-in region on
    # device; otherwise theta_chains is the full [C, m, P] chain.
    post = theta_chains if fast_path else theta_chains[:, burn_in:, :]
    theta_chain_dict = {
        p: post[:, :, j] for j, p in enumerate(param_names)
    }

    param_ess, param_rhat = {}, {}
    ess_message_shown = False
    for j, p in enumerate(param_names):
        mat = post[:, :, j].T  # [iters, chains]
        if num_chains > 1:
            param_ess[p] = float(ess_matrix(mat))
        else:
            param_ess[p] = float("nan")
            if not ess_message_shown:
                print(
                    "ESS cannot be computed with only one chain "
                    "Run at least 2 chains."
                )
                ess_message_shown = True
        param_rhat[p] = float(rhat_matrix(mat)) if post.shape[1] >= 2 else float("nan")

    result = PMMHOutput(
        theta_chain=theta_chain_dict,
        diagnostics={"ess": param_ess, "rhat": param_rhat},
        latent_state_chain=(
            (state_chains if fast_path else state_chains[:, burn_in:])
            if return_latent_state_est
            else None
        ),
        acceptance_rate=accept_rates,
        target_n=target_n,
        seed=seed_out,
        timings=dict(timer.timings),
        chunk_memory=chunk_memory,
    )

    if print_summary:
        print(result)

    if any(
        not np.isnan(v) and v < 400 for v in param_ess.values()
    ):
        warnings.warn(
            "Some ESS values are below 400, indicating poor mixing. "
            "Consider running the chains for more iterations."
        )
    if any(
        not np.isnan(v) and v > 1.01 for v in param_rhat.values()
    ):
        warnings.warn(
            "\nSome Rhat values are above 1.01, indicating that the chains "
            "have not converged. \nConsider running the chains for more "
            "iterations and/or increase burn_in."
        )

    return result
