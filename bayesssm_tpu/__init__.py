"""bayesssm_tpu — Particle Marginal Metropolis-Hastings in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the R package
``BjarkeHautop/bayesSSM`` (reference layout documented in SURVEY.md):
Bayesian inference for state-space models via particle filters (bootstrap,
auxiliary, resample-move) and PMMH with pilot-run tuning, running thousands
of chains in parallel on one accelerator or a device mesh.

Public surface mirrors the reference's exported NAMESPACE
(/root/reference/NAMESPACE:3-11): pmmh, bootstrap_filter, auxiliary_filter,
resample_move_filter, default_tune_control, ess, rhat, plus output
printing/summaries. One beyond-NAMESPACE export: ``build_sweep_pf_impl``,
the whole-sweep kernel builder — the performance escape hatch this
framework offers where the reference points users at Rcpp
(/root/reference/vignettes/articles/detailed-overview.Rmd:401-470).
"""

__version__ = "0.1.0"

_EXPORTS = {
    "SSM": "bayesssm_tpu.ssm",
    "particle_filter_core": "bayesssm_tpu.filters.core",
    "FilterResult": "bayesssm_tpu.filters.core",
    "FilterConfig": "bayesssm_tpu.filters.core",
    "MeshConfig": "bayesssm_tpu.parallel.mesh",
    "bootstrap_filter": "bayesssm_tpu.filters.bootstrap",
    "auxiliary_filter": "bayesssm_tpu.filters.auxiliary",
    "resample_move_filter": "bayesssm_tpu.filters.resample_move",
    "pmmh": "bayesssm_tpu.pmmh.driver",
    "default_tune_control": "bayesssm_tpu.pmmh.tuning",
    "TuneControl": "bayesssm_tpu.pmmh.tuning",
    "ess": "bayesssm_tpu.diagnostics.ess",
    "rhat": "bayesssm_tpu.diagnostics.rhat",
    "PMMHOutput": "bayesssm_tpu.output",
    "build_sweep_pf_impl": "bayesssm_tpu.ops.sweep_builder",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    # Lazy exports: keeps `import bayesssm_tpu.ops` cheap and avoids import
    # cycles while the package is under construction.
    if name in _EXPORTS:
        import importlib

        module = importlib.import_module(_EXPORTS[name])
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
