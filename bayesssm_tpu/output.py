"""PMMH output container with print/summary reporting.

Python analogue of the reference's S3 ``pmmh_output`` class and its
``print``/``summary`` methods (/root/reference/R/print.R:30-66,
R/summary.R:28-54): pooled posterior mean/SD/median/95% credible interval
per parameter, with floor(ESS) and 3-decimal Rhat in the printed table.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np

__all__ = ["PMMHOutput"]


@dataclasses.dataclass
class PMMHOutput:
    """Result of a PMMH run.

    Attributes:
      theta_chain: dict param -> [num_chains, m_post] post-burn-in samples.
      diagnostics: {"ess": {param: float}, "rhat": {param: float}}.
      latent_state_chain: optional [num_chains, m_post, T+1(, d)] filtered
        state estimates per kept iteration.
      acceptance_rate: [num_chains] main-chain MH acceptance rates.
      target_n: [num_chains] tuned particle counts (reference Q9).
      seed: the seed/key data the run derived its randomness from.
      timings: wall-clock seconds per phase (tuning, compile, sampling).
      chunk_memory: byte counts of the compiled sampling-chunk program
        (``memory_analysis()`` of the longest chunk): arguments, outputs,
        temporaries and generated code.
    """

    theta_chain: Dict[str, np.ndarray]
    diagnostics: Dict[str, Dict[str, float]]
    latent_state_chain: Optional[np.ndarray] = None
    acceptance_rate: Optional[np.ndarray] = None
    target_n: Optional[np.ndarray] = None
    seed: Optional[int] = None
    timings: Optional[Dict[str, float]] = None
    chunk_memory: Optional[Dict[str, int]] = None

    @property
    def param_names(self):
        return list(self.theta_chain.keys())

    @property
    def num_chains(self) -> int:
        first = next(iter(self.theta_chain.values()))
        return first.shape[0]

    def pooled(self, param: str) -> np.ndarray:
        """All post-burn-in samples of a parameter pooled across chains."""
        return np.asarray(self.theta_chain[param]).ravel()

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Unrounded summary statistics per parameter.

        Mirrors summary.pmmh_output (R/summary.R:28-54): mean, sd (ddof=1),
        median, 2.5%/97.5% quantiles (type-7), ESS, Rhat.
        """
        out = {}
        for param in self.param_names:
            s = self.pooled(param)
            out[param] = {
                "mean": float(np.mean(s)),
                "sd": float(np.std(s, ddof=1)),
                "median": float(np.median(s)),
                "2.5%": float(np.quantile(s, 0.025)),
                "97.5%": float(np.quantile(s, 0.975)),
                "ESS": self.diagnostics.get("ess", {}).get(param, float("nan")),
                "Rhat": self.diagnostics.get("rhat", {}).get(param, float("nan")),
            }
        return out

    def to_dataframe(self):
        """Summary as a pandas DataFrame (if pandas is available)."""
        import pandas as pd

        summ = self.summary()
        return pd.DataFrame.from_dict(summ, orient="index")

    def chains_dataframe(self):
        """Post-burn-in draws in the reference's long layout.

        The reference's ``pmmh_output`` IS this data.frame — chains bound
        row-wise with a ``chain`` id column plus one column per parameter
        (R/pmmh.R:596-608). Feed it straight to ``ess()``/``rhat()``.
        """
        import pandas as pd

        cols = {}
        for param in self.param_names:
            cols[param] = np.asarray(self.theta_chain[param]).ravel()
        first = np.asarray(next(iter(self.theta_chain.values())))
        k, m = first.shape
        cols["chain"] = np.repeat(np.arange(1, k + 1), m)
        return pd.DataFrame(cols)

    def __str__(self) -> str:
        rows = []
        for param in self.param_names:
            s = self.pooled(param)
            ess_val = self.diagnostics.get("ess", {}).get(param, float("nan"))
            rhat_val = self.diagnostics.get("rhat", {}).get(param, float("nan"))
            rows.append(
                (
                    param,
                    f"{np.mean(s):.2f}",
                    f"{np.std(s, ddof=1):.2f}",
                    f"{np.median(s):.2f}",
                    f"{np.quantile(s, 0.025):.2f}",
                    f"{np.quantile(s, 0.975):.2f}",
                    "NA" if ess_val is None or math.isnan(ess_val)
                    else str(int(math.floor(ess_val))),
                    "NA" if rhat_val is None or math.isnan(rhat_val)
                    else f"{rhat_val:.3f}",
                )
            )
        header = ("Parameter", "Mean", "SD", "Median", "2.5%", "97.5%", "ESS", "Rhat")
        widths = [
            max(len(header[i]), *(len(r[i]) for r in rows))
            for i in range(len(header))
        ]
        lines = ["PMMH Results Summary:"]
        lines.append(" ".join(h.rjust(w) for h, w in zip(header, widths)))
        for r in rows:
            lines.append(" ".join(c.rjust(w) for c, w in zip(r, widths)))
        return "\n".join(lines)

    def print(self) -> "PMMHOutput":
        print(self)
        return self
