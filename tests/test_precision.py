"""Numerical-precision validation (SURVEY.md §7 hard parts).

* f32 vs f64: the reference is double-precision R; the engine runs
  float32 with max-shifted log-weight arithmetic. A subprocess with
  JAX_ENABLE_X64 runs the same filter in float64 and the f32 estimate must
  agree within MC-noise-scale tolerance.
* jax_debug_nans: the branchless -inf propagation must not generate NaNs
  anywhere in the normal path, so the engine stays usable under
  jax.config.jax_debug_nans.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from bayesssm_tpu.filters.bootstrap import bootstrap_filter
from bayesssm_tpu.models.lgss import lgss_model, simulate_lgss

(MODEL_FNS, _, _) = lgss_model()
INIT_FN, TRANSITION_FN, LOGLIK_FN = MODEL_FNS
THETA = {"a": 0.9, "sigma_x": 0.6, "sigma_y": 0.4}

_SUBPROCESS_F64 = r"""
import os
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import json
import numpy as np
import jax.numpy as jnp
from bayesssm_tpu.filters.bootstrap import bootstrap_filter
from bayesssm_tpu.models.lgss import lgss_model, simulate_lgss

(fns, _, _) = lgss_model()
init_fn, trans_fn, loglik_fn = fns
_, y = simulate_lgss(1405, t_val=20)

def init64(key, num_particles):
    return jax.random.normal(key, (num_particles,), dtype=jnp.float64)

@jax.jit
def batched(keys):
    def one(k):
        return bootstrap_filter(
            k, y, 2048, init64, trans_fn, loglik_fn,
            theta={"a": 0.9, "sigma_x": 0.6, "sigma_y": 0.4},
            resample_algorithm="SISR", return_particles=False,
        ).loglike
    return jax.vmap(one)(keys)

lls = batched(jax.vmap(jax.random.key)(jnp.arange(16)))
assert lls.dtype == jnp.float64
lls = np.asarray(lls)
print(json.dumps({"mean": float(np.mean(lls)), "std": float(np.std(lls))}))
"""


def test_f32_matches_f64_crosscheck():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["JAX_ENABLE_X64"] = "1"
    proc = subprocess.run(
        [sys.executable, "-c", _SUBPROCESS_F64],
        capture_output=True, text=True, env=env, cwd=os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))
        ),
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    f64 = json.loads(proc.stdout.strip().splitlines()[-1])

    _, y = simulate_lgss(1405, t_val=20)

    @jax.jit
    def batched(keys):
        def one(k):
            return bootstrap_filter(
                k, y, 2048, INIT_FN, TRANSITION_FN,
                LOGLIK_FN, theta=THETA, resample_algorithm="SISR",
                return_particles=False,
            ).loglike
        return jax.vmap(one)(keys)

    lls = np.asarray(
        batched(jax.random.split(jax.random.key(100), 16)), dtype=np.float64
    )
    # Same estimator at different precisions: means agree within combined
    # MC error (std/sqrt(16) each, ~0.03 here).
    assert abs(np.mean(lls) - f64["mean"]) < 0.1


def test_engine_clean_under_debug_nans():
    _, y = simulate_lgss(3, t_val=10)
    jax.config.update("jax_debug_nans", True)
    try:
        res = bootstrap_filter(
            jax.random.key(0), y, 256, INIT_FN, TRANSITION_FN, LOGLIK_FN,
            theta=THETA, return_particles=False,
        )
        assert np.isfinite(float(res.loglike))
    finally:
        jax.config.update("jax_debug_nans", False)
