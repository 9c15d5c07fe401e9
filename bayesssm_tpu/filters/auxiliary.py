"""Auxiliary particle filter (APF, Pitt & Shephard 1999).

Public adapter mirroring /root/reference/R/auxiliary_filter.R:163-216: adds
a lookahead ``aux_log_likelihood_fn`` whose log-weights steer an extra
resampling step before propagation; the final weights are corrected by
subtracting the auxiliary log-weights of the chosen ancestors. The core
reproduces the reference's double-transition behavior exactly (SURVEY.md Q2).
"""

from __future__ import annotations

from bayesssm_tpu.filters.core import particle_filter_core

__all__ = ["auxiliary_filter"]


def auxiliary_filter(
    key,
    y,
    num_particles,
    init_fn,
    transition_fn,
    log_likelihood_fn,
    aux_log_likelihood_fn,
    theta=None,
    obs_times=None,
    resample_algorithm: str = "SISAR",
    resample_fn: str = "stratified",
    threshold=None,
    return_particles: bool = True,
    max_particles=None,
    carry_weights: bool = False,
):
    """Run an auxiliary particle filter; returns a ``FilterResult``."""
    return particle_filter_core(
        key=key,
        y=y,
        num_particles=num_particles,
        init_fn=init_fn,
        transition_fn=transition_fn,
        weight_fn=log_likelihood_fn,
        aux_weight_fn=aux_log_likelihood_fn,
        theta=theta,
        obs_times=obs_times,
        algorithm="APF",
        resample_algorithm=resample_algorithm,
        resample_fn=resample_fn,
        threshold=threshold,
        return_particles=return_particles,
        max_particles=max_particles,
        carry_weights=carry_weights,
    )
