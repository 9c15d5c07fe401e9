"""Vectorized resampling kernels.

Vectorized replacement for the reference's native resampling layer
(/root/reference/src/resampling.cpp:5-66 and the R dispatch wrappers in
/root/reference/R/resampling.R:13-69). The reference draws ancestor indices
with a serial inverse-CDF walk in C++; here the same three schemes
(multinomial / stratified / systematic) are expressed as
``cumsum -> positions -> searchsorted -> gather`` so they vectorize over a
``[chains, particles]`` layout and batch cleanly under ``vmap``/``shard_map``.

Distributional contracts (matching src/resampling.cpp):
  * multinomial — iid inverse-CDF draws, ``u_j ~ U[0,1)``            (:5-13)
  * stratified  — one draw per stratum, ``u_j = (j + U_j)/n``        (:16-40)
  * systematic  — shared offset, ``u_j = (j + U)/n``                 (:43-66)
with ancestor ``a_j = min{ i : cdf_i >= u_j }`` (the C++ walks the cumulative
sum with ``>=`` semantics; ``searchsorted(..., side='left')`` is identical).

Masked-particle support: ``num_alive`` (a traced scalar or per-batch array)
restricts resampling to the first ``num_alive`` lanes — the mechanism that
lets PMMH keep the reference's per-chain tuned particle counts (SURVEY.md Q9)
under a single static shape. Dead output lanes receive position 1.0 and are
clipped onto the last alive ancestor; callers keep them masked out.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "resample_indices",
    "resample_multinomial",
    "resample_stratified",
    "resample_systematic",
    "metropolis_resample_indices",
    "gather_particles",
    "sharded_resample_indices",
    "sharded_gather",
    "RESAMPLE_METHODS",
]

RESAMPLE_METHODS = ("stratified", "systematic", "multinomial", "metropolis")


def _validate_weights_eager(weights) -> None:
    """Reference weight-validation contract, enforced in eager mode.

    The reference raises at both the C++ kernel and the R wrapper
    (/root/reference/src/resampling.cpp:6-8,17-23,44-50 and
    tests/testthat/test-resampling.R:2-28,71-134). Under a jit trace the
    values are abstract and no check is possible (degenerate weights
    propagate branchlessly instead — filters/core.py); eagerly, the same
    messages are raised.
    """
    if isinstance(weights, jax.core.Tracer):
        return
    import numpy as np

    w = np.asarray(weights)
    if (w < 0).any():
        raise ValueError("Weights must be non-negative")
    if not (w.sum(axis=-1) > 0).all():
        raise ValueError("Sum of weights must be greater than 0")


def metropolis_resample_indices(
    key: jax.Array,
    weights: jnp.ndarray,
    num_steps: int | None = None,
    num_alive: jnp.ndarray | None = None,
    num_out: int | None = None,
) -> jnp.ndarray:
    """Metropolis resampling (Murray 2012, arXiv:1202.6163).

    A sort-free alternative to inverse-CDF resampling: every output slot
    runs ``num_steps`` Metropolis steps over ancestor indices with
    acceptance ratio ``w_proposal / w_current`` — no cumulative sum, no
    sorted lookups, fully lane-parallel, which makes it attractive on very
    wide accelerators and for sharded particle populations. The chain
    targets the correct categorical distribution; finite ``num_steps``
    introduces a small bias that decays ~1/num_steps (round-4 LGSS
    calibration: +1.04 nats log-likelihood bias at 32 steps, +0.11 at
    256, roughly ~35/num_steps and nearly constant in n between 512 and
    2048 lanes). The default ``num_steps = max(256, n // 8)`` keeps the
    bias at the ~0.1-nat level for the weight profiles tested; raise it
    for heavily concentrated weights.

    Not part of the reference's surface (it ships only multinomial/
    stratified/systematic); reachable through every filter as
    ``resample_fn="metropolis"`` (portable and particle-sharded paths;
    the whole-sweep kernel keeps its inverse-CDF selection).

    ``num_alive`` restricts proposals to the first ``num_alive`` lanes
    (masked-lane semantics, SURVEY.md Q9). ``num_out`` sets the number of
    output slots (default: one per weight lane) — the sharded path uses
    it to run only its own slots' chains against the global weights.
    """
    weights = jnp.asarray(weights)
    n = weights.shape[-1]
    calibrated = max(256, n // 8)
    if num_steps is None:
        num_steps = calibrated
    elif num_steps < 1:
        raise ValueError(
            f"num_steps must be >= 1 (got {num_steps}); a zero-length "
            "Metropolis chain would return the identity resample"
        )
    elif num_steps < calibrated:
        import warnings

        # One-shot guard (default warning filter: once per location):
        # the ~35/num_steps bias calibration is only validated at or
        # above the default; fewer steps with concentrated weights can
        # bias the likelihood by whole nats (tests/test_resampling.py::
        # TestMetropolisBias pins the envelope).
        warnings.warn(
            f"metropolis resampling with num_steps={num_steps} below "
            f"the calibrated default {calibrated}: expect a "
            f"log-likelihood bias of roughly 35/num_steps = "
            f"{35.0 / num_steps:.2f} nats (worse for concentrated "
            "weights)",
            stacklevel=2,
        )
    n_out = n if num_out is None else int(num_out)
    batch_shape = weights.shape[:-1]
    dtype = weights.dtype
    if num_alive is None:
        alive_f = jnp.full(batch_shape + (1,), n, dtype=dtype)
    else:
        alive_f = jnp.broadcast_to(
            jnp.asarray(num_alive, dtype=dtype), batch_shape
        )[..., None]
    last_alive = (alive_f - 1.0).astype(jnp.int32)
    idx0 = jnp.minimum(
        jnp.broadcast_to(
            jnp.arange(n_out, dtype=jnp.int32), batch_shape + (n_out,)
        ),
        last_alive,
    )

    def step(idx, k):
        k_u, k_p = jax.random.split(k)
        # floor(u * num_alive): uniform over the alive lanes even when
        # num_alive is traced (randint needs static bounds).
        up = jax.random.uniform(k_p, batch_shape + (n_out,), dtype=dtype)
        proposal = jnp.minimum(
            jnp.floor(up * alive_f).astype(jnp.int32), last_alive
        )
        u = jax.random.uniform(k_u, batch_shape + (n_out,), dtype=dtype)
        w_cur = jnp.take_along_axis(weights, idx, axis=-1)
        w_prop = jnp.take_along_axis(weights, proposal, axis=-1)
        accept = u * w_cur < w_prop
        return jnp.where(accept, proposal, idx), None

    idx, _ = jax.lax.scan(step, idx0, jax.random.split(key, num_steps))
    return idx


def _batched_searchsorted(cdf: jnp.ndarray, pos: jnp.ndarray) -> jnp.ndarray:
    """searchsorted(side='left') over matching leading batch dims."""
    if cdf.ndim == 1:
        return jnp.searchsorted(cdf, pos, side="left")
    batch = cdf.shape[:-1]
    flat_cdf = cdf.reshape((-1, cdf.shape[-1]))
    flat_pos = pos.reshape((-1, pos.shape[-1]))
    out = jax.vmap(lambda c, p: jnp.searchsorted(c, p, side="left"))(
        flat_cdf, flat_pos
    )
    return out.reshape(batch + (pos.shape[-1],))


def _positions(key, method: str, batch_shape, n: int, num_alive, dtype):
    """Inverse-CDF query positions for each output slot."""
    slots = jnp.arange(n, dtype=dtype)
    if method == "systematic":
        u = jax.random.uniform(key, batch_shape, dtype=dtype)
        pos = (slots + u[..., None]) / num_alive[..., None]
    elif method == "stratified":
        u = jax.random.uniform(key, batch_shape + (n,), dtype=dtype)
        pos = (slots + u) / num_alive[..., None]
    elif method == "multinomial":
        pos = jax.random.uniform(key, batch_shape + (n,), dtype=dtype)
    else:
        raise ValueError(
            f"unknown resampling method {method!r}; expected one of {RESAMPLE_METHODS}"
        )
    # Slots at or beyond num_alive are dead: aim them at the end of the CDF.
    alive = slots < num_alive[..., None]
    return jnp.where(alive, pos, jnp.asarray(1.0, dtype))


def resample_indices(
    key: jax.Array,
    weights: jnp.ndarray,
    method: str = "systematic",
    num_alive: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Draw ancestor indices from self-normalized ``weights``.

    Args:
      key: PRNG key.
      weights: ``[..., n]`` self-normalized weights (zeros on masked lanes).
      method: one of ``stratified | systematic | multinomial``.
      num_alive: optional traced count of live lanes per batch element
        (defaults to the static lane count ``n``).

    Returns:
      ``[..., n]`` int32 ancestor indices in ``[0, num_alive)``.
    """
    weights = jnp.asarray(weights)
    _validate_weights_eager(weights)
    n = weights.shape[-1]
    batch_shape = weights.shape[:-1]
    dtype = weights.dtype
    if num_alive is None:
        num_alive = jnp.full(batch_shape, n, dtype=dtype)
    else:
        num_alive = jnp.broadcast_to(
            jnp.asarray(num_alive, dtype=dtype), batch_shape
        )
    if method == "metropolis":
        return metropolis_resample_indices(
            key, weights, num_alive=num_alive
        )
    cdf = jnp.cumsum(weights, axis=-1)
    pos = _positions(key, method, batch_shape, n, num_alive, dtype)
    idx = _batched_searchsorted(cdf, pos)
    # Float cumsum error can leave cdf[last_alive] slightly below the largest
    # query position; clamp into the alive range.
    last_alive = (num_alive - 1).astype(jnp.int32)
    return jnp.clip(idx.astype(jnp.int32), 0, last_alive[..., None])


def gather_particles(particles: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """Gather particle rows by ancestor index.

    ``particles``: ``[..., n, d]`` or ``[..., n]``; ``idx``: ``[..., n]``.
    The R wrappers' vector/matrix dual dispatch
    (/root/reference/R/resampling.R:13-29) collapses to one take-along-axis.
    """
    if particles.ndim == idx.ndim:
        return jnp.take_along_axis(particles, idx, axis=-1)
    return jnp.take_along_axis(particles, idx[..., None], axis=-2)


def sharded_resample_indices(
    key: jax.Array,
    weights_local: jnp.ndarray,
    method: str,
    axis_name: str,
    num_alive: jnp.ndarray | float,
) -> jnp.ndarray:
    """Distributed inverse-CDF resampling over a sharded particle axis.

    ``weights_local`` is this shard's ``[n_local]`` slice of GLOBALLY
    normalized weights (see ``normalize_log_weights(axis_name=...)``).
    Every shard draws the SAME stratum offsets from ``key`` (the caller
    must pass a key that is identical across shards), reconstructs the
    global CDF with one ``all_gather``, and answers only its own output
    slots — so the joint ancestor distribution is exactly the unsharded
    ``resample_indices`` contract (the reference's serial C++ walk,
    /root/reference/src/resampling.cpp, made collective).

    Returns this shard's ``[n_local]`` GLOBAL ancestor indices; pair with
    ``sharded_gather`` to fetch the ancestors' rows.
    """
    from jax import lax

    n_local = weights_local.shape[-1]
    dtype = weights_local.dtype
    w_all = lax.all_gather(weights_local, axis_name, axis=0, tiled=True)
    n_global = w_all.shape[0]
    num_alive = jnp.asarray(num_alive, dtype=dtype)
    if method == "metropolis":
        # Each shard runs the Metropolis chains for ITS OWN output slots
        # over the gathered global weights; per-shard streams derive from
        # fold_in(key, shard) (bit-reproducible per layout, statistically
        # invariant across layouts — the chain RNG convention).
        k_shard = jax.random.fold_in(key, lax.axis_index(axis_name))
        return metropolis_resample_indices(
            k_shard, w_all, num_alive=num_alive, num_out=n_local
        )
    # Positions for ALL global slots (shard-identical RNG), then slice this
    # shard's slots — reusing _positions keeps the masked-lane semantics
    # (dead slots aim at the CDF end and clamp onto the last alive lane).
    pos_full = _positions(key, method, (), n_global, num_alive, dtype)
    p_idx = lax.axis_index(axis_name)
    slots = p_idx * n_local + jnp.arange(n_local)
    pos = jnp.take(pos_full, slots)
    cdf = jnp.cumsum(w_all)
    idx = jnp.searchsorted(cdf, pos, side="left")
    last_alive = (num_alive - 1).astype(jnp.int32)
    return jnp.clip(idx.astype(jnp.int32), 0, last_alive)


def sharded_gather(
    x_local: jnp.ndarray, idx_global: jnp.ndarray, axis_name: str
) -> jnp.ndarray:
    """Gather rows by GLOBAL ancestor index from a sharded array.

    ``x_local``: ``[n_local]`` or ``[n_local, d]`` shard slice;
    ``idx_global``: ``[n_local]`` global indices from
    ``sharded_resample_indices``. One ``all_gather`` materializes the
    global array (particle counts here are small relative to device
    memory; the win from sharding is the model's transition cost, not the gather).
    """
    from jax import lax

    x_all = lax.all_gather(x_local, axis_name, axis=0, tiled=True)
    return jnp.take(x_all, idx_global, axis=0)


def _resample(method):
    def fn(key, particles, weights, num_alive=None):
        n = weights.shape[-1]
        pn = particles.shape[-2] if particles.ndim > weights.ndim else particles.shape[-1]
        if pn != n:
            raise ValueError(
                "Number of particles must match the length of weights"
            )
        idx = resample_indices(key, weights, method=method, num_alive=num_alive)
        return gather_particles(particles, idx)

    fn.__name__ = f"resample_{method}"
    fn.__doc__ = (
        f"{method.capitalize()} resampling: draw ancestors and gather particles.\n"
        "Mirrors /root/reference/R/resampling.R wrapper semantics."
    )
    return fn


resample_multinomial = _resample("multinomial")
resample_stratified = _resample("stratified")
resample_systematic = _resample("systematic")
