"""Resample-move particle filter (RMPF, Gilks & Berzuini 2001).

Public adapter mirroring /root/reference/R/resample_move_filter.R:190-236:
resampling is forced to every step (SISR) and an MCMC rejuvenation
``move_fn`` runs after each resample. Unlike the reference's per-particle R
loop (/root/reference/R/particle_filter_core.R:228-233), ``move_fn`` here is
vectorized over the whole ``[num_particles, d]`` block — the natural
formulation for an accelerator.
"""

from __future__ import annotations

from bayesssm_tpu.filters.core import particle_filter_core

__all__ = ["resample_move_filter"]


def resample_move_filter(
    key,
    y,
    num_particles,
    init_fn,
    transition_fn,
    log_likelihood_fn,
    move_fn,
    theta=None,
    obs_times=None,
    resample_fn: str = "stratified",
    return_particles: bool = True,
    max_particles=None,
    carry_weights: bool = False,
):
    """Run a resample-move particle filter; returns a ``FilterResult``.

    Note: there is no ``resample_algorithm`` argument — RMPF always
    resamples (the reference strips a user-supplied value,
    /root/reference/R/resample_move_filter.R:213-216, :230).
    """
    return particle_filter_core(
        key=key,
        y=y,
        num_particles=num_particles,
        init_fn=init_fn,
        transition_fn=transition_fn,
        weight_fn=log_likelihood_fn,
        move_fn=move_fn,
        theta=theta,
        obs_times=obs_times,
        algorithm="RMPF",
        resample_algorithm="SISR",
        resample_fn=resample_fn,
        return_particles=return_particles,
        max_particles=max_particles,
        carry_weights=carry_weights,
    )
