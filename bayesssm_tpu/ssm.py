"""State-space model specification.

The reference's model contract (/root/reference/R/particle_filter-doc.R:43-73)
is three user closures: ``init_fn``, ``transition_fn``, ``log_likelihood_fn``
with model parameters as extra named arguments. Here the same contract is a
small bundle of pure JAX functions with explicit PRNG keys:

    init_fn(key, num_particles, **theta)          -> particles [n] or [n, d]
    transition_fn(key, particles, t, **theta)     -> particles (same shape)
    log_likelihood_fn(y, particles, t, **theta)   -> log-weights [n]
    aux_log_likelihood_fn(y, particles, t, **theta) -> [n]   (APF only)
    move_fn(key, particles, y, t, **theta)        -> particles (RMPF only)

Functions declare only the arguments they use (signature adaptation mirrors
the reference's formals injection, see utils/signatures.py). ``move_fn`` is
vectorized over all particles at once — the vectorized fix of the
reference's per-particle loop (/root/reference/R/particle_filter_core.R:228-233).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from bayesssm_tpu.utils.signatures import adapt_fn, check_params_match

__all__ = ["SSM"]


@dataclasses.dataclass(frozen=True)
class SSM:
    """Bundle of user model functions defining a state-space model."""

    init_fn: Callable
    transition_fn: Callable
    log_likelihood_fn: Callable
    aux_log_likelihood_fn: Optional[Callable] = None
    move_fn: Optional[Callable] = None

    def adapted(self):
        """Return signature-adapted callables for the engine's keyword set."""
        init = adapt_fn(self.init_fn, "init_fn", required=("num_particles",))
        trans = adapt_fn(self.transition_fn, "transition_fn", required=("particles",))
        loglik = adapt_fn(
            self.log_likelihood_fn, "log_likelihood_fn", required=("particles", "y")
        )
        aux = (
            adapt_fn(self.aux_log_likelihood_fn, "aux_log_likelihood_fn",
                     required=("particles", "y"))
            if self.aux_log_likelihood_fn is not None
            else None
        )
        move = (
            adapt_fn(self.move_fn, "move_fn", required=())
            if self.move_fn is not None
            else None
        )
        return init, trans, loglik, aux, move

    def check_params_match(self, pilot_init_params, log_priors) -> None:
        check_params_match(
            self.init_fn,
            self.transition_fn,
            self.log_likelihood_fn,
            pilot_init_params,
            log_priors,
        )
