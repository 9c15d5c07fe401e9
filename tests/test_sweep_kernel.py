"""Internals of the Triton whole-sweep kernel (ops/sweep_builder.py).

The kernel's selection step, random stream, chain blocking and wrapper
checks, tested directly: in interpret mode on the CPU, and compiled on
the card by the tests marked ``gpu`` (tests/conftest.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bayesssm_tpu.ops import sweep_builder
from bayesssm_tpu.ops.resampling import _positions, resample_indices
from bayesssm_tpu.ops.sweep_builder import (
    _chains_per_program,
    _hash32,
    _num_warps,
    build_sweep_op,
    lane_streams,
    select_columns,
    uniform_block,
)

ROUTES = ["interpret", pytest.param("compiled", marks=pytest.mark.gpu)]


def _route(route, request):
    """``interpret`` flag for a route; the compiled route needs the card."""
    if route == "compiled":
        request.getfixturevalue("gpu_device")
        return False
    return True


# ---------------------------------------------------------------- selection


def _selection_call(w, pos, num_alive, col, interpret):
    """Run ``select_columns`` alone, one chain per program."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    c, n = w.shape

    def barrier():
        if not interpret:
            plgpu.debug_barrier()

    def kernel(w_ref, pos_ref, alive_ref, col_ref, anc_ref, out_ref, scr_ref):
        row = pl.program_id(0) + jnp.zeros((1, 1), jnp.int32)
        lane = jax.lax.broadcasted_iota(jnp.int32, (1, n), 1)
        idx = row * n + lane
        anc, (sel,) = select_columns(
            scr_ref, row * (2 * n), lane, w_ref[idx], pos_ref[idx],
            (col_ref[idx],), alive_ref[row].astype(jnp.int32) - 1, barrier,
        )
        anc_ref[idx] = anc
        out_ref[idx] = sel

    anc, sel, _ = pl.pallas_call(
        kernel,
        grid=(c,),
        out_shape=(
            jax.ShapeDtypeStruct((c * n,), jnp.int32),
            jax.ShapeDtypeStruct((c * n,), jnp.float32),
            jax.ShapeDtypeStruct((c * 2 * n,), jnp.float32),
        ),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
    )(w.reshape(-1), pos.reshape(-1), num_alive, col.reshape(-1))
    return anc.reshape(c, n), sel.reshape(c, n)


def _weights(case, n, c=8, seed=0):
    """``[c, n]`` normalised weights and per-chain alive counts."""
    rng = np.random.default_rng(seed + n)
    alive = np.full(c, n, np.float32)
    w = rng.gamma(0.5, size=(c, n)).astype(np.float32)
    if case == "masked":
        alive = rng.integers(n // 4, n, size=c).astype(np.float32)
        w = np.where(np.arange(n)[None, :] < alive[:, None], w, 0.0)
    elif case == "degenerate":
        # One live lane per chain holds all the mass: long runs of exact
        # zeros give flat CDF stretches (ties) before and after it.
        w = np.zeros((c, n), np.float32)
        w[np.arange(c), rng.integers(0, n, size=c)] = 1.0
        w[0, :] = 0.0
        w[0, n - 1] = 1.0
    w = w / w.sum(axis=1, keepdims=True)
    return jnp.asarray(w, jnp.float32), jnp.asarray(alive)


@pytest.mark.parametrize("case", ["full", "masked", "degenerate"])
@pytest.mark.parametrize("n", [128, 256, 512, 1024])
def test_selection_matches_resampling(n, case):
    """Given the same positions, the kernel's ancestors are exactly
    ``ops/resampling.py``'s and the gathered column is the ancestors'."""
    w, alive = _weights(case, n)
    key = jax.random.key(n)
    pos = _positions(key, "stratified", (w.shape[0],), n, alive, jnp.float32)
    col = jnp.broadcast_to(
        jnp.arange(n, dtype=jnp.float32) * 0.5 - 3.0, w.shape
    )
    anc, sel = _selection_call(w, pos, alive, col, interpret=True)
    ref = resample_indices(key, w, method="stratified", num_alive=alive)
    np.testing.assert_array_equal(np.asarray(anc), np.asarray(ref))
    np.testing.assert_array_equal(
        np.asarray(sel), np.take_along_axis(np.asarray(col), np.asarray(ref), 1)
    )


@pytest.mark.gpu
def test_selection_compiled_matches_resampling(gpu_device):
    """Compiled on the card: the CDF is summed in another order than
    XLA's, so an ancestor may flip where a position falls within float32
    rounding of a CDF value. Such flips are rare: at most 0.1% of the
    ancestors, each onto a neighbouring lane."""
    for n in (128, 1024):
        w, alive = _weights("full", n, c=256, seed=3)
        key = jax.random.key(n)
        pos = _positions(
            key, "stratified", (w.shape[0],), n, alive, jnp.float32
        )
        col = jnp.broadcast_to(jnp.arange(n, dtype=jnp.float32), w.shape)
        anc, sel = _selection_call(w, pos, alive, col, interpret=False)
        ref = np.asarray(
            resample_indices(key, w, method="stratified", num_alive=alive)
        )
        anc = np.asarray(anc)
        assert np.mean(anc != ref) <= 1e-3, np.mean(anc != ref)
        assert np.abs(anc - ref).max() <= 1
        np.testing.assert_array_equal(np.asarray(sel), anc.astype(np.float32))


@pytest.mark.parametrize("n", [2, 4, 8, 16])
def test_search_sorted_left_matches_numpy(n):
    """The branchless search equals searchsorted(side='left') clipped to
    the last lane, ties and out-of-range positions included."""
    cdf = np.array([0.0, 0.25, 0.25, 0.5, 0.5, 0.5, 0.75, 1.0] * 2)[:n]
    cdf = np.sort(cdf).astype(np.float32)
    pos = np.array([-1.0, 0.0, 0.1, 0.25, 0.3, 0.5, 0.9, 1.0, 2.0],
                   np.float32)
    got = sweep_builder.search_sorted_left(
        lambda i: jnp.asarray(cdf)[i], jnp.asarray(pos), n
    )
    want = np.minimum(np.searchsorted(cdf, pos, side="left"), n - 1)
    np.testing.assert_array_equal(np.asarray(got), want)


# ------------------------------------------------------------ random stream


def _np_lowbias32(x):
    x = np.asarray(x, np.uint32).copy()
    x ^= x >> np.uint32(16)
    x *= np.uint32(0x7FEB352D)
    x ^= x >> np.uint32(15)
    x *= np.uint32(0x846CA68B)
    x ^= x >> np.uint32(16)
    return x


@pytest.mark.parametrize(
    "values",
    [
        np.arange(1000),
        np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 1]),
        np.random.default_rng(0).integers(0, 2**32, 4096),
    ],
    ids=["counting", "edges", "random"],
)
def test_hash32_matches_numpy_lowbias32(values):
    x = np.asarray(values, np.uint32)
    np.testing.assert_array_equal(
        np.asarray(_hash32(jnp.asarray(x))), _np_lowbias32(x)
    )


def test_uniform_block_matches_numpy_stream():
    """Block k of lane l is hash(lane_key ^ hash(k)) >> 8, scaled by
    2^-24 (the module docstring's stream), reproduced in NumPy."""
    s0 = jnp.asarray([[7], [9]], jnp.uint32)
    s1 = jnp.asarray([[1], [2]], jnp.uint32)
    keys = lane_streams(s0, s1, 64)
    chain = _np_lowbias32(
        np.array([[7], [9]], np.uint32)
        ^ _np_lowbias32(np.array([[1], [2]], np.uint32))
    )
    lane = np.arange(64, dtype=np.uint32)[None, :]
    want_keys = _np_lowbias32(chain + lane * np.uint32(0x9E3779B9))
    np.testing.assert_array_equal(np.asarray(keys), want_keys)
    u = uniform_block(keys, jnp.int32(5))
    bits = _np_lowbias32(want_keys ^ _np_lowbias32(np.uint32(5)))
    np.testing.assert_array_equal(
        np.asarray(u), (bits >> 8).astype(np.float32) / np.float32(2**24)
    )


def test_uniform_stream_moments_and_decorrelation():
    s0 = jnp.arange(64, dtype=jnp.uint32)[:, None]
    s1 = jnp.zeros((64, 1), jnp.uint32)
    keys = lane_streams(s0, s1, 256)
    u = np.stack([np.asarray(uniform_block(keys, jnp.int32(k)))
                  for k in range(8)])
    assert u.min() >= 0.0 and u.max() < 1.0
    assert abs(u.mean() - 0.5) < 0.005
    assert abs(u.var() - 1.0 / 12.0) < 0.003
    # Neighbouring lanes, chains and blocks are uncorrelated.
    for a, b in [(u[:, :, :-1], u[:, :, 1:]), (u[:, :-1], u[:, 1:]),
                 (u[:-1], u[1:])]:
        assert abs(np.corrcoef(a.ravel(), b.ravel())[0, 1]) < 0.02


# --------------------------------------------------- blocking and wrapper


@pytest.mark.parametrize(
    "c, n, b",
    [(4096, 128, 1), (512, 1024, 1), (2, 64, 2), (3, 16, 4), (100, 16, 8),
     (1, 16, 1)],
)
def test_chains_per_program(c, n, b):
    assert _chains_per_program(c, n) == b


@pytest.mark.parametrize(
    "lanes, warps", [(16, 4), (128, 4), (256, 4), (512, 8), (1024, 16),
                     (4096, 16)],
)
def test_num_warps(lanes, warps):
    assert _num_warps(lanes) == warps


def _lgss_op(**kw):
    def init(rng, theta):
        return (rng.normal(),)

    def trans(rng, cols, theta, t):
        return (theta[0] * cols[0] + theta[1] * rng.normal(),)

    def lw(cols, theta, y_t):
        r = (y_t - cols[0]) / theta[2]
        return -0.5 * r * r - jnp.log(theta[2])

    return build_sweep_op(1, init, trans, lw, 3, interpret=True, **kw)


def _run(op, keys, n=16, y=None):
    y = jnp.linspace(-1.0, 1.0, 5) if y is None else y
    theta = jnp.array([0.9, 0.6, 0.4], jnp.float32)
    return jax.vmap(lambda k: op(k, y, theta, n))(keys)


def test_chain_padding_and_layout_do_not_change_results(monkeypatch):
    """A chain's result depends on its key only: not on how many chains
    share its call (padding), nor on the chains per program."""
    keys = jax.random.split(jax.random.key(3), 8)
    ll8, est8 = _run(_lgss_op(), keys)            # 8 chains, one program
    ll3, est3 = _run(_lgss_op(), keys[:3])        # 3 chains + 1 padded
    np.testing.assert_array_equal(np.asarray(ll3), np.asarray(ll8)[:3])
    np.testing.assert_array_equal(np.asarray(est3), np.asarray(est8)[:3])
    monkeypatch.setattr(sweep_builder, "_LANES_PER_PROGRAM", 16)
    ll1, est1 = _run(_lgss_op(), keys)            # one chain per program
    np.testing.assert_array_equal(np.asarray(ll1), np.asarray(ll8))
    np.testing.assert_array_equal(np.asarray(est1), np.asarray(est8))


@pytest.mark.parametrize("n", [3, 100, 384])
def test_rejects_lane_counts_that_are_not_powers_of_two(n):
    with pytest.raises(ValueError, match="power of two"):
        _run(_lgss_op(), jax.random.split(jax.random.key(0), 2), n=n)


@pytest.mark.parametrize(
    "kw, match",
    [
        (dict(resample_fn="multinomial"), "sorted positions"),
        (dict(pack_fn=lambda c: c), "together"),
        (dict(always_resample=True, never_resample=True), "exclusive"),
        (dict(obs_gaps=(1, 0, 1, 1, 1)), ">= 1"),
    ],
    ids=["multinomial", "pack-without-unpack", "always-and-never", "gap0"],
)
def test_builder_rejects_bad_options(kw, match):
    with pytest.raises(ValueError, match=match):
        _lgss_op(**kw)


def test_rejects_observations_that_do_not_fit():
    keys = jax.random.split(jax.random.key(0), 2)
    with pytest.raises(ValueError, match="obs_gaps has 3 entries"):
        _run(_lgss_op(obs_gaps=(1, 2, 1)), keys)
    with pytest.raises(ValueError, match=r"y must be \[T, 2\]"):
        _run(_lgss_op(num_obs_cols=2), keys)


def test_rejects_vmapped_observations():
    op = _lgss_op()
    theta = jnp.array([0.9, 0.6, 0.4], jnp.float32)
    ys = jnp.zeros((2, 5))
    with pytest.raises(ValueError, match="cannot be vmapped"):
        jax.vmap(lambda k, y: op(k, y, theta, 16))(
            jax.random.split(jax.random.key(0), 2), ys
        )


# ------------------------------------------------ kernel against XLA/itself


@pytest.mark.parametrize("route", ROUTES)
def test_gillespie_stream_moments_match_xla(route, request):
    """One exact SIR day driven by the in-kernel stream has the moments of
    the XLA simulator (models/sir.py::gillespie_step) driven by
    jax.random: means of S and I and the variance of I within 5 standard
    errors."""
    from bayesssm_tpu.models.sir import gillespie_step
    from bayesssm_tpu.ops.sir_sweep_pallas import sir_sweep_parts

    interpret = _route(route, request)
    lam, gam, n_total, i0 = 0.5, 0.2, 500, 70
    sir_trans = sir_sweep_parts(n_total, i0)["transition_fn"]

    def init(rng, theta):
        s = jnp.full_like(theta[0], float(n_total - i0))
        i = jnp.full_like(theta[0], float(i0))
        return s, i, i * i

    def trans(rng, cols, theta, t):
        s, i = sir_trans(rng, cols[:2], theta, t)
        return s, i, i * i

    op = build_sweep_op(
        3, init, trans, lambda cols, theta, y_t: jnp.zeros_like(cols[0]),
        2, never_resample=True, interpret=interpret,
    )
    c, n = (16, 128) if interpret else (256, 1024)
    keys = jax.random.split(jax.random.key(11), c)
    theta = jnp.array([lam, gam], jnp.float32)
    _, est = jax.jit(jax.vmap(lambda k: op(k, jnp.zeros(1), theta, n)))(keys)
    est = np.asarray(est, np.float64)[:, 1]           # [c, 3] after day 1
    s_k, i_k, i2_k = est.mean(axis=0)

    state = jnp.tile(jnp.array([n_total - i0, i0], jnp.float32), (40000, 1))
    ref = np.asarray(
        gillespie_step(jax.random.key(5), state, lam, gam, float(n_total)),
        np.float64,
    )
    s_x, i_x = ref.mean(axis=0)
    var_x = ref[:, 1].var()
    se = np.sqrt(var_x / (c * n) + var_x / ref.shape[0])
    assert abs(i_k - i_x) < 5 * se, (i_k, i_x, se)
    se_s = np.sqrt(ref[:, 0].var() * (1.0 / (c * n) + 1.0 / ref.shape[0]))
    assert abs(s_k - s_x) < 5 * se_s, (s_k, s_x, se_s)
    # Relative standard error of a sample variance: sqrt(2 / samples).
    tol = 5 * np.sqrt(2.0 / (c * n) + 2.0 / ref.shape[0])
    assert abs((i2_k - i_k**2) / var_x - 1.0) < tol, (i2_k - i_k**2, var_x)


@pytest.mark.gpu
def test_compiled_matches_interpret_lgss(gpu_device):
    """The compiled kernel and its interpret run draw the same bits. Their
    results differ only where the card's transcendentals differ from the
    CPU's in the last bit: at least 95% of the chains agree within
    1e-3 in log-likelihood (the rest took another ancestor at a CDF tie
    and wandered off by Monte-Carlo noise)."""
    from bayesssm_tpu.models.lgss import simulate_lgss
    from bayesssm_tpu.ops.lgss_sweep_pallas import lgss_bpf_sweep

    _, y = simulate_lgss(11, t_val=20, a=0.9, sigma_x=0.6, sigma_y=0.4)
    ys = jnp.asarray(y, jnp.float32)
    keys = jax.random.split(jax.random.key(2), 256)

    def run(interpret):
        f = jax.vmap(lambda k: lgss_bpf_sweep(
            k, ys, 128, 0.9, 0.6, 0.4, resample_algorithm="SISR",
            interpret=interpret,
        ))
        return np.asarray(jax.jit(f)(keys)[0], np.float64)

    compiled, interp = run(False), run(True)
    assert np.isfinite(compiled).all()
    agree = np.abs(compiled - interp) < 1e-3
    assert agree.mean() >= 0.95, agree.mean()
