"""Bootstrap particle filter (BPF).

Public adapter mirroring /root/reference/R/bootstrap_filter.R:129-171: the
weight function is the observation log-likelihood itself, and everything
else dispatches to the shared core with ``algorithm="BPF"``. Defaults match
the reference: SISAR adaptive resampling with stratified resampling.
"""

from __future__ import annotations

from bayesssm_tpu.filters.core import particle_filter_core

__all__ = ["bootstrap_filter"]


def bootstrap_filter(
    key,
    y,
    num_particles,
    init_fn,
    transition_fn,
    log_likelihood_fn,
    theta=None,
    obs_times=None,
    resample_algorithm: str = "SISAR",
    resample_fn: str = "stratified",
    threshold=None,
    return_particles: bool = True,
    max_particles=None,
    carry_weights: bool = False,
):
    """Run a bootstrap particle filter; returns a ``FilterResult``."""
    return particle_filter_core(
        key=key,
        y=y,
        num_particles=num_particles,
        init_fn=init_fn,
        transition_fn=transition_fn,
        weight_fn=log_likelihood_fn,
        theta=theta,
        obs_times=obs_times,
        algorithm="BPF",
        resample_algorithm=resample_algorithm,
        resample_fn=resample_fn,
        threshold=threshold,
        return_particles=return_particles,
        max_particles=max_particles,
        carry_weights=carry_weights,
    )
