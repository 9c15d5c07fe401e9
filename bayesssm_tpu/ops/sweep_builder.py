"""Generic whole-sweep kernel builder: the escape hatch as a public API.

Runs the ENTIRE T-observation particle filter as ONE Pallas kernel
through Triton (``backend="triton"``): each program holds a small block
of chains with all their particles in registers for every observation,
draws its random numbers from an in-kernel counter-based generator, and
resamples by an inverse-CDF search. Any model whose state is a tuple of
``[B, N]`` float columns gets a whole-sweep ``pf_impl`` by writing three
small callbacks instead of a kernel:

    pf_impl = build_sweep_pf_impl(
        num_state_cols=1,
        init_fn=lambda rng, theta: (theta[3] * rng.normal(),),
        transition_fn=lambda rng, cols, theta, t: (
            theta[0] * cols[0] + theta[1] * rng.normal(),),
        log_weight_fn=lambda cols, theta, y_t: gaussian_lw(...),
        param_names=("a", "sigma_x", "sigma_y"),
    )
    pmmh(..., pf_impl=pf_impl)

Callback contract (TRUSTED, like every ``pf_impl``):
  * All state columns and every value ``rng.normal()`` / ``rng.uniform()``
    return are ``[B, N]`` float32 arrays (B chains of one program, N
    particle lanes). Callbacks trace into the Triton kernel: they may use
    ``jnp`` elementwise operations, reductions along the lane axis and
    ``lax`` control flow (``while_loop``/``fori_loop``/``cond``), but no
    gather, scatter, sort, concatenation or ``jnp.stack`` (Triton lowers
    none of them inside a block).
  * ``theta`` is a tuple of ``[B, N]`` broadcasts of the per-chain
    parameters, ordered as ``param_names``.
  * ``rng`` is a :class:`SweepRng` over the kernel's lowbias32 counter
    stream; callbacks may draw any number of blocks.
  * ``log_weight_fn`` returns the UNMASKED ``[B, N]`` observation
    log-density; the scaffold applies the alive-lane mask, degeneracy
    flag, normalization, likelihood increment, resampling
    (stratified/systematic), and state-estimate recording.
  * Optional ``aux_log_weight_fn(cols, theta, y_t)`` enables the APF day
    (forced aux resample + the reference's Q2 second transition);
    optional ``move_fn(rng, cols, theta, y_t)`` enables the RMPF day
    (forced SISR + rejuvenation move).

Semantics match ``filters/core.py`` with the default fresh-weight
``carry_weights=False`` (quirks Q2/Q4/Q5, masked lanes Q9, degenerate
-inf contract), validated distributionally in tests/test_sweep_builder.py
against the plain engine.

Random stream: lane ``l`` of the chain whose key data is ``(s0, s1)``
draws block ``k`` as ``hash(lane_key ^ hash(k))`` with
``lane_key = hash(hash(s0 ^ hash(s1)) + l * 0x9E3779B9)``, the lowbias32
finalizer :func:`_hash32`. The stream depends on the chain's key and the
lane only, never on the program layout, so the compiled kernel and its
``interpret=True`` run on the CPU draw the same bits at any chains per
program.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["build_sweep_pf_impl", "build_sweep_op", "SweepRng"]

# Lanes per program (chains per program x particles). Chains in one
# program share the transition callback's control flow, so an event loop
# runs until the slowest chain of the block is done: fewer chains per
# program terminate closer to each chain's own event count. Measured on
# an H100 for SIR BPF/APF/RMPF at 4096 chains x 128 particles against
# 256 and 512 lanes (PERF.md).
_LANES_PER_PROGRAM = 128
_NEG = np.float32(-1e30)
_DEGENERATE = np.float32(-1e8)
_INV24 = np.float32(1.0 / (1 << 24))


def _hash32(x):
    """lowbias32 integer finalizer (uint32 in, uint32 out): the kernel's
    counter-based generator step. uint32 multiply wraps mod 2^32, as the
    hash is defined."""
    x = x ^ (x >> jnp.uint32(16))
    x = x * jnp.uint32(0x7FEB352D)
    x = x ^ (x >> jnp.uint32(15))
    x = x * jnp.uint32(0x846CA68B)
    x = x ^ (x >> jnp.uint32(16))
    return x


def _num_warps(lanes: int) -> int:
    """Warps per program: 4 up to 256 lanes, then one warp per 64 lanes,
    at most 16 (measured on an H100: 4 beat 2 and 8 at 128 lanes; 16 beat
    4 and 8 at 1024 lanes, PERF.md)."""
    return max(4, min(16, lanes // 64))


def _chains_per_program(c: int, n: int) -> int:
    """Power-of-two chains per program: ``_LANES_PER_PROGRAM // n``
    chains, at least one, and no more than ``c`` rounded up."""
    b = max(1, _LANES_PER_PROGRAM // n)
    return min(b, 1 << max(0, (c - 1).bit_length()))


class SweepRng:
    """In-kernel RNG handle passed to callbacks (uniforms + normals).

    Callbacks that run their OWN jax control flow (e.g. an event
    while_loop drawing per iteration, like the SIR Gillespie day) cannot
    use the stateful :meth:`uniform`/:meth:`normal` inside the loop body
    — the Python-attribute counter would leak a tracer out of the loop.
    Thread the counter explicitly instead::

        ctr = rng.counter()
        def body(carry):
            ..., ctr = carry
            u, ctr = rng.raw_uniform_blocks(k, ctr)   # pure function
            ...
        ... = lax.while_loop(cond, body, (..., ctr))
        rng.set_counter(ctr_out)   # BEFORE returning from the callback
    """

    def __init__(self, draw, ctr=None):
        self._draw = draw
        self._ctr = jnp.int32(0) if ctr is None else ctr

    def uniform(self):
        """One [B, N] uniform f32 block in [0, 1)."""
        u, self._ctr = self._draw(1, self._ctr)
        return u[0]

    def uniforms(self, k):
        """``k`` [B, N] uniform blocks, as a tuple."""
        u, self._ctr = self._draw(int(k), self._ctr)
        return u

    def normal(self):
        """One [B, N] standard-normal block (Box-Muller)."""
        u, self._ctr = self._draw(2, self._ctr)
        r = jnp.sqrt(-2.0 * jnp.log(1.0 - u[0]))
        return r * jnp.cos(np.float32(2.0 * np.pi) * u[1])

    def counter(self):
        """Current draw counter (int32, may be traced)."""
        return self._ctr

    def set_counter(self, ctr):
        """Restore the counter after explicit threading (docstring)."""
        self._ctr = ctr

    def raw_uniform_blocks(self, nblk, ctr):
        """``nblk`` [B, N] uniform blocks as a PURE function of ``ctr``.

        Returns ``(blocks (tuple of nblk), new_ctr)``; does NOT touch the
        handle's own counter — for use inside callback-managed control
        flow with the counter in the loop carry.
        """
        return self._draw(nblk, ctr)


def lane_streams(s0, s1, n: int):
    """Per-lane stream keys ``[..., n]`` (uint32) from per-chain key words
    ``s0, s1`` of shape ``[..., 1]`` (module docstring)."""
    lane = jax.lax.broadcasted_iota(
        jnp.int32, tuple(s0.shape[:-1]) + (n,), s0.ndim - 1
    ).astype(jnp.uint32)
    chain = _hash32(s0 ^ _hash32(s1))
    return _hash32(chain + lane * jnp.uint32(0x9E3779B9))


def uniform_block(lane_key, ctr):
    """Block ``ctr`` of the stream: uniforms in [0, 1) on a 2^-24 grid."""
    ctr_key = _hash32(jax.lax.convert_element_type(ctr, jnp.uint32))
    bits = _hash32(lane_key ^ ctr_key)
    return (bits >> jnp.uint32(8)).astype(jnp.int32).astype(
        jnp.float32
    ) * _INV24


def search_sorted_left(load_cdf, pos, n: int):
    """``searchsorted(cdf, pos, side='left')`` for a power-of-two ``n``,
    as a branchless binary search whose probes go through
    ``load_cdf(idx) -> cdf[idx]``.

    Each step keeps the invariant that every entry below ``idx`` is
    ``< pos``. The result lies in ``[0, n - 1]``; callers clip to the
    last alive lane, which makes it equal to ``ops/resampling.py``'s
    clipped ``searchsorted``.
    """
    idx = jnp.zeros(pos.shape, jnp.int32)
    step = n // 2
    while step >= 1:
        probe = load_cdf(idx + (step - 1))
        idx = jnp.where(probe < pos, idx + step, idx)
        step //= 2
    return idx


def select_columns(scr_ref, scr_row, lane, w, pos, cols, last_alive,
                   barrier):
    """Inverse-CDF selection inside a kernel: ancestors and their columns.

    ``w``/``pos``/``cols[j]`` are ``[B, N]`` (weights, sorted positions,
    state columns); ``lane`` is the ``[B, N]`` lane iota, ``last_alive``
    the ``[B, 1]`` index of each row's last alive lane. The CDF and the
    columns pass through ``1 + len(cols)`` scratch rows of N values per
    chain, starting at flat offset ``scr_row`` (``[B, 1]``) of
    ``scr_ref``: stored once, then read at the search probes and at the
    ancestors. ``barrier()`` separates a lane's store from other lanes'
    loads. Returns ``(ancestors [B, N] int32, selected columns)``.
    """
    n = w.shape[-1]
    cdf = jnp.cumsum(w, axis=-1)
    barrier()  # the previous selection's loads are done
    scr_ref[scr_row + lane] = cdf
    for j, c in enumerate(cols):
        scr_ref[scr_row + (j + 1) * n + lane] = c
    barrier()
    anc = search_sorted_left(lambda i: scr_ref[scr_row + i], pos, n)
    anc = jnp.minimum(anc, last_alive)
    sel = tuple(
        scr_ref[scr_row + (j + 1) * n + anc] for j in range(len(cols))
    )
    return anc, sel


def _make_kernel(n, b, num_obs, d, d_route, p, init_fn, transition_fn,
                 log_weight_fn, aux_log_weight_fn, move_fn, method,
                 always_resample, interpret, d_y=1, pack_fn=None,
                 unpack_fn=None, gapped=False, never_resample=False):
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    t1 = num_obs + 1
    slots = d_route + 1  # scratch rows per chain: routed columns + CDF

    def barrier():
        # Within one program, a lane loads what another lane stored: the
        # warps must meet in between. Sequential interpretation needs none.
        if not interpret:
            plgpu.debug_barrier()

    def kernel(*refs):
        y_ref, seed_ref = refs[:2]
        base = 2
        if gapped:
            gaps_ref, times_ref = refs[2:4]
            base = 4
        theta_ref, alive_ref, thr_ref, ll_ref, est_ref, scr_ref = refs[
            base : base + 6
        ]

        pid = pl.program_id(0)
        rows = pid * b + jax.lax.broadcasted_iota(jnp.int32, (b, 1), 0)
        lane = jax.lax.broadcasted_iota(jnp.int32, (b, n), 1)
        lane_f = lane.astype(jnp.float32)
        alive_ct = alive_ref[rows]
        thr = thr_ref[rows]
        alive_mask = lane_f < alive_ct
        last_alive = alive_ct.astype(jnp.int32) - 1
        theta = tuple(
            jnp.broadcast_to(theta_ref[rows * p + j], (b, n))
            for j in range(p)
        )
        s0 = jax.lax.bitcast_convert_type(seed_ref[rows * 2], jnp.uint32)
        s1 = jax.lax.bitcast_convert_type(seed_ref[rows * 2 + 1], jnp.uint32)
        lane_key = lane_streams(s0, s1, n)
        scr_row = rows * (slots * n)

        def draw(nblk, ctr):
            blocks = tuple(
                uniform_block(lane_key, ctr + k) for k in range(nblk)
            )
            return blocks, ctr + jnp.int32(nblk)

        def draw_positions(rng):
            u = rng.uniform()
            if method == "stratified":
                pos = (lane_f + u) / alive_ct
            else:  # systematic: lane 0's draw is the shared offset
                u0 = jnp.max(jnp.where(lane == 0, u, 0.0), axis=-1,
                             keepdims=True)
                pos = (lane_f + u0) / alive_ct
            return jnp.where(alive_mask, pos, 1.0)

        def masked_lw(cols, y_t):
            lw = log_weight_fn(cols, theta, y_t)
            return jnp.where(alive_mask, lw, _NEG)

        def select_state(w, pos, cols):
            """Inverse-CDF resample of ``cols`` (pack -> gather ->
            unpack)."""
            route = tuple(pack_fn(cols)) if pack_fn is not None else cols
            _, sel = select_columns(
                scr_ref, scr_row, lane, w, pos, route, last_alive, barrier
            )
            if unpack_fn is not None:
                sel = tuple(unpack_fn(sel))
            return tuple(jnp.where(alive_mask, o, 0.0) for o in sel)

        def record(t, cols, est_w, live_f):
            for j, c in enumerate(cols):
                v = jnp.sum(est_w * c, axis=-1, keepdims=True) * live_f
                est_ref[(rows * t1 + t) * d + j] = v

        rng = SweepRng(draw)
        cols = tuple(init_fn(rng, theta))
        if len(cols) != d:
            raise ValueError("init_fn must return num_state_cols columns")
        w0 = jnp.where(alive_mask, 1.0 / alive_ct, 0.0)
        record(0, cols, w0, jnp.ones((b, 1), jnp.float32))
        loglike = jnp.zeros((b, 1), jnp.float32)
        dead = jnp.zeros((b, 1), jnp.float32)

        def day(t, carry):
            cols, loglike, dead, ctr = carry
            rng = SweepRng(draw, ctr)
            y_t = (
                y_ref[t] if d_y == 1
                else tuple(y_ref[t * d_y + j] for j in range(d_y))
            )

            if gapped:
                # Irregular observation grid (gap-propagation loop of
                # /root/reference/R/particle_filter_core.R:122-137):
                # apply the transition gaps[t] times; the callback's time
                # argument is the absolute 0-based transition index
                # times[t] - gaps[t] + s, which reduces to the day index
                # t on a contiguous grid.
                gap = gaps_ref[t]
                t_end = times_ref[t]

                def gap_body(s, gcarry):
                    gcols, gctr = gcarry
                    grng = SweepRng(draw, gctr)
                    gcols = tuple(
                        transition_fn(grng, gcols, theta, t_end - gap + s)
                    )
                    return gcols, grng.counter()

                cols, ctr2 = jax.lax.fori_loop(
                    0, gap, gap_body, (cols, rng.counter())
                )
                rng.set_counter(ctr2)
            else:
                cols = tuple(transition_fn(rng, cols, theta, t))

            if aux_log_weight_fn is not None:
                aux_lw = jnp.where(
                    alive_mask, aux_log_weight_fn(cols, theta, y_t), _NEG
                )
                mxa = jnp.max(aux_lw, axis=-1, keepdims=True)
                dead = jnp.maximum(
                    dead, (mxa < _DEGENERATE).astype(jnp.float32)
                )
                sha = jnp.exp(aux_lw - mxa)
                wa = sha / jnp.sum(sha, axis=-1, keepdims=True)
                cols = select_state(wa, draw_positions(rng), cols)
                # The ancestor's aux weight is recomputed from the
                # selected state: selection copies (and pack/unpack) are
                # exact and the aux weight is a deterministic function of
                # (cols, theta, y_t), so this equals gathering it.
                aux_anc = jnp.maximum(
                    jnp.where(
                        alive_mask,
                        aux_log_weight_fn(cols, theta, y_t), _NEG,
                    ),
                    _NEG,
                )
                # Q2: ONE second transition at the observation time
                # (times[t] - 1 == t on a contiguous grid).
                t_q2 = times_ref[t] - 1 if gapped else t
                cols = tuple(transition_fn(rng, cols, theta, t_q2))
                lw = masked_lw(cols, y_t) - aux_anc
                lw = jnp.where(alive_mask, lw, _NEG)
            else:
                lw = masked_lw(cols, y_t)

            mx = jnp.max(lw, axis=-1, keepdims=True)
            dead = jnp.maximum(dead, (mx < _DEGENERATE).astype(jnp.float32))
            shifted = jnp.exp(lw - mx)
            ssum = jnp.sum(shifted, axis=-1, keepdims=True)
            w = shifted / ssum
            ess = 1.0 / jnp.sum(w * w, axis=-1, keepdims=True)
            loglike = loglike + mx + jnp.log(ssum) - jnp.log(alive_ct)

            uniform_w = jnp.where(alive_mask, 1.0 / alive_ct, 0.0)
            if never_resample:
                # SIS day: no selection (the fresh-weight SIS of the
                # plain engine with carry_weights=False).
                est_w = w
            else:
                res = select_state(w, draw_positions(rng), cols)
                if always_resample:
                    cols = res
                    est_w = uniform_w
                else:
                    do_rows = jnp.broadcast_to(ess < thr, (b, n))
                    cols = tuple(
                        jnp.where(do_rows, r, c) for r, c in zip(res, cols)
                    )
                    est_w = jnp.where(do_rows, uniform_w, w)

            if move_fn is not None:
                moved = tuple(move_fn(rng, cols, theta, y_t))
                # Masked lanes stay inert.
                cols = tuple(
                    jnp.where(alive_mask, m, c) for m, c in zip(moved, cols)
                )

            record(t + 1, cols, est_w, 1.0 - dead)
            return cols, loglike, dead, rng.counter()

        _, loglike, dead, _ = jax.lax.fori_loop(
            0, num_obs, day, (cols, loglike, dead, rng.counter())
        )
        ll_ref[rows] = jnp.where(dead > 0.0, -jnp.inf, loglike)

    return kernel


def _batched_call(seeds, thetas, alive, thr, y, *, n_static, d, init_fn,
                  transition_fn, log_weight_fn, aux_log_weight_fn,
                  move_fn, method, always_resample, interpret,
                  d_y=1, pack_fn=None, unpack_fn=None, num_packed_cols=1,
                  gaps=None, never_resample=False):
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    c = thetas[0].shape[0]
    p = len(thetas)
    n = n_static
    num_obs = y.shape[0]
    t1 = num_obs + 1
    gapped = gaps is not None
    d_route = num_packed_cols if pack_fn is not None else d

    b = _chains_per_program(c, n)
    g = -(-c // b)
    pad = g * b - c
    if pad:
        seeds = jnp.pad(seeds, [(0, pad), (0, 0)])
        # Padded chains replicate the LAST chain's theta (mode="edge" —
        # any real chain's theta is in-support) with one alive lane;
        # padded outputs are discarded.
        thetas = tuple(jnp.pad(t, (0, pad), mode="edge") for t in thetas)
        alive = jnp.pad(alive, (0, pad), constant_values=1.0)
        thr = jnp.pad(thr, (0, pad), constant_values=1.0)
    cp = g * b

    kernel = _make_kernel(
        n, b, int(num_obs), d, d_route, p, init_fn, transition_fn,
        log_weight_fn, aux_log_weight_fn, move_fn, method,
        bool(always_resample), bool(interpret), d_y=int(d_y),
        pack_fn=pack_fn, unpack_fn=unpack_fn, gapped=gapped,
        never_resample=bool(never_resample),
    )
    gap_args = []
    if gapped:
        gaps_np = np.asarray(gaps, np.int32)
        gap_args = [
            jnp.asarray(gaps_np),
            jnp.asarray(np.cumsum(gaps_np).astype(np.int32)),
        ]
    ll, est, _ = pl.pallas_call(
        kernel,
        grid=(g,),
        out_shape=(
            jax.ShapeDtypeStruct((cp,), jnp.float32),
            jax.ShapeDtypeStruct((cp * t1 * d,), jnp.float32),
            jax.ShapeDtypeStruct((cp * (d_route + 1) * n,), jnp.float32),
        ),
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=_num_warps(b * n), num_stages=1
        ),
        interpret=interpret,
        name="sweep_filter",
    )(
        y.astype(jnp.float32).reshape(num_obs * d_y),
        seeds.reshape(cp * 2),
        *gap_args,
        jnp.stack(thetas, axis=1).astype(jnp.float32).reshape(cp * p),
        alive.astype(jnp.float32),
        thr.astype(jnp.float32),
    )
    est = est.reshape(cp, t1, d)[:c]
    return ll[:c], (est[..., 0] if d == 1 else est)


def build_sweep_op(
    num_state_cols: int,
    init_fn,
    transition_fn,
    log_weight_fn,
    num_params: int,
    aux_log_weight_fn=None,
    move_fn=None,
    resample_fn: str = "stratified",
    always_resample: bool = False,
    never_resample: bool = False,
    interpret: bool = False,
    num_obs_cols: int = 1,
    pack_fn=None,
    unpack_fn=None,
    num_packed_cols: int = 1,
    obs_gaps=None,
):
    """Build the vmap-aware whole-sweep op (module docstring contract).

    Returns ``op(key, y [T] or [T, num_obs_cols], theta_vec [P],
    num_particles, max_particles, threshold) -> (loglike,
    state_est [T+1(, d)])``.

    ``num_obs_cols`` (d_y): observation columns; callbacks receive
    ``y_t`` as a scalar when 1 or a tuple of d_y scalars (multivariate
    rows, /root/reference/R/particle_filter_core.R:176-183 — also usable
    for per-observation precomputed constants like ``lgamma(y + 1)``).

    ``pack_fn(cols) -> tuple`` / ``unpack_fn(packed) -> cols`` (with
    ``num_packed_cols`` = the packed tuple's length) optionally shrink
    the column set the resample gathers — e.g. two integer counts packed
    into one exact f32 value. The gather copies values exactly, so
    packing changes no result when ``unpack_fn(pack_fn(cols))`` returns
    ``cols`` bit for bit.

    ``obs_gaps``: static per-observation transition counts (tuple of
    ints >= 1, one per observation) for irregular observation grids
    (/root/reference/R/particle_filter_core.R:122-137). ``None`` = one
    transition per observation (contiguous). The callback's time
    argument is the absolute 0-based transition index.

    ``interpret=True`` runs the same kernel under the Pallas interpreter
    (CPU tests); it draws the same random bits as the compiled kernel.
    """
    if resample_fn not in ("stratified", "systematic"):
        raise ValueError(
            "the sweep builder resamples by a search over sorted positions "
            "(stratified or systematic)"
        )
    if (pack_fn is None) != (unpack_fn is None):
        raise ValueError("pack_fn and unpack_fn must be given together")
    if always_resample and never_resample:
        raise ValueError(
            "always_resample and never_resample are mutually exclusive"
        )
    if obs_gaps is not None:
        obs_gaps = tuple(int(g) for g in obs_gaps)
        if any(g < 1 for g in obs_gaps):
            raise ValueError("obs_gaps entries must be >= 1")
        if all(g == 1 for g in obs_gaps):
            obs_gaps = None  # contiguous: keep the no-inner-loop path

    d_y = int(num_obs_cols)
    kw = dict(
        d=int(num_state_cols), init_fn=init_fn,
        transition_fn=transition_fn, log_weight_fn=log_weight_fn,
        aux_log_weight_fn=aux_log_weight_fn, move_fn=move_fn,
        method=resample_fn, always_resample=bool(always_resample),
        never_resample=bool(never_resample),
        interpret=bool(interpret), d_y=d_y, pack_fn=pack_fn,
        unpack_fn=unpack_fn, num_packed_cols=int(num_packed_cols),
        gaps=obs_gaps,
    )
    p = int(num_params)

    def make(n_static):
        @jax.custom_batching.custom_vmap
        def op(seeds, thetas, alive, thr, y):
            ll, est = _batched_call(
                seeds[None], tuple(t[None] for t in thetas),
                alive[None], thr[None], y, n_static=n_static, **kw,
            )
            return ll[0], est[0]

        @op.def_vmap
        def _rule(axis_size, in_batched, seeds, thetas, alive, thr, y):
            if in_batched[4]:
                raise ValueError(
                    "sweep builder: y is shared across chains and cannot "
                    "be vmapped"
                )

            def ensure(x, batched):
                return x if batched else jnp.broadcast_to(
                    x[None], (axis_size,) + x.shape
                )

            seeds_b = ensure(seeds, in_batched[0])
            thetas_b = tuple(
                ensure(t, bt) for t, bt in zip(
                    thetas,
                    in_batched[1] if isinstance(in_batched[1], (list, tuple))
                    else [in_batched[1]] * p,
                )
            )
            alive_b = ensure(alive, in_batched[2])
            thr_b = ensure(thr, in_batched[3])
            out = _batched_call(
                seeds_b, thetas_b, alive_b, thr_b, y,
                n_static=n_static, **kw,
            )
            return out, (True, True)

        return op

    make = functools.lru_cache(maxsize=None)(make)

    def call(key, y, theta_vec, num_particles, max_particles=None,
             threshold=None):
        if max_particles is None:
            max_particles = int(num_particles)
        n_static = int(max_particles)
        if n_static < 1 or n_static & (n_static - 1):
            raise ValueError(
                "max_particles must be a power of two (got "
                f"{n_static}); Triton blocks span a power-of-two number "
                "of lanes"
            )
        ys = jnp.asarray(y, jnp.float32)
        if d_y == 1:
            ys = ys.reshape(-1, 1)
        elif ys.ndim != 2 or ys.shape[1] != d_y:
            raise ValueError(
                f"y must be [T, {d_y}] for num_obs_cols={d_y} "
                f"(got shape {ys.shape})"
            )
        if obs_gaps is not None and len(obs_gaps) != ys.shape[0]:
            raise ValueError(
                f"obs_gaps has {len(obs_gaps)} entries but y has "
                f"{ys.shape[0]} observations"
            )
        kd = jnp.ravel(jax.random.key_data(key))[:2]
        seeds = jax.lax.bitcast_convert_type(
            kd.astype(jnp.uint32), jnp.int32
        )
        alive = jnp.asarray(num_particles, jnp.float32).reshape(())
        thr = (
            jnp.asarray(threshold, jnp.float32).reshape(())
            if threshold is not None
            else alive / 2.0
        )
        theta_vec = jnp.asarray(theta_vec, jnp.float32)
        thetas = tuple(theta_vec[j].reshape(()) for j in range(p))
        return make(n_static)(seeds, thetas, alive, thr, ys)

    return call


def build_sweep_pf_impl(
    num_state_cols: int,
    init_fn,
    transition_fn,
    log_weight_fn,
    param_names,
    aux_log_weight_fn=None,
    move_fn=None,
    interpret: bool = False,
    num_obs_cols: int = 1,
    pack_fn=None,
    unpack_fn=None,
    num_packed_cols: int = 1,
    obs_transform=None,
):
    """PMMH ``pf_impl`` factory over :func:`build_sweep_op`.

    ``param_names`` fixes the order of the ``theta`` tuple the callbacks
    receive. Supports BPF (plus APF when ``aux_log_weight_fn`` is given
    and RMPF when ``move_fn`` is given), fresh-weight SIS/SISR/SISAR
    (SIS compiles a never-resample day that skips selection entirely),
    stratified/systematic resampling, multivariate observation rows
    (``num_obs_cols``), irregular ``obs_times`` (static gap counts,
    compiled into the kernel's day loop), and optional selection
    packing (see :func:`build_sweep_op`).

    ``obs_transform(y) -> [T, num_obs_cols]``: optional host-side map
    applied to the driver's raw ``y`` once per pmmh() call — the place
    to append precomputed per-observation constants the kernel should
    not recompute per lane (e.g. ``lgamma(y + 1)`` for a Poisson
    weight).
    """
    expected_params = tuple(param_names)

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
        if algorithm not in ("BPF", "APF", "RMPF"):
            raise ValueError(
                "the sweep builder supports BPF, APF or RMPF only"
            )
        if algorithm == "APF" and aux_log_weight_fn is None:
            raise ValueError(
                "APF requires the builder's aux_log_weight_fn"
            )
        if algorithm == "RMPF" and move_fn is None:
            raise ValueError("RMPF requires the builder's move_fn")
        if obs_times is not None:
            from bayesssm_tpu.filters.core import obs_times_to_gaps

            obs_gaps = obs_times_to_gaps(
                obs_times, int(jnp.asarray(y).shape[0])
            )
        else:
            obs_gaps = None
        if carry_weights:
            raise ValueError(
                "the sweep builder implements the reference fresh-weight "
                "semantics (carry_weights=False)"
            )
        if set(param_names) != set(expected_params):
            raise ValueError(
                f"sweep builder built for parameters {expected_params}, "
                f"driver passed {tuple(param_names)}"
            )
        # The callbacks see theta ordered as the BUILDER's param_names;
        # the driver passes theta_vec in ITS param order (whatever order
        # the user's log_priors dict iterates).
        perm = tuple(param_names.index(q) for q in expected_params)
        # RMPF strips any user resample_algorithm and forces SISR
        # (/root/reference/R/resample_move_filter.R:213-230), so SIS
        # only survives outside RMPF.
        always = (
            algorithm == "RMPF" or resample_algorithm == "SISR"
        )
        never = resample_algorithm == "SIS" and algorithm != "RMPF"
        op = build_sweep_op(
            num_state_cols, init_fn, transition_fn, log_weight_fn,
            len(expected_params),
            aux_log_weight_fn=(
                aux_log_weight_fn if algorithm == "APF" else None
            ),
            move_fn=move_fn if algorithm == "RMPF" else None,
            resample_fn=resample_fn, always_resample=always,
            never_resample=never,
            interpret=interpret, num_obs_cols=num_obs_cols,
            pack_fn=pack_fn, unpack_fn=unpack_fn,
            num_packed_cols=num_packed_cols, obs_gaps=obs_gaps,
        )
        ys = jnp.asarray(y, jnp.float32)
        if obs_transform is not None:
            ys = jnp.asarray(obs_transform(ys), jnp.float32)

        def pf(key, theta_vec, n=num_particles):
            theta_vec = jnp.asarray(theta_vec)
            if perm != tuple(range(len(perm))):
                theta_vec = theta_vec[jnp.array(perm)]
            return op(
                key, ys, theta_vec, n,
                max_particles=max_particles
                if max_particles is not None
                else n,
            )

        return pf

    return factory
