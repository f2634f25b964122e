"""Dispatch of a document's "analysis" block (counterpart of
pinn_fem_tpu/io/analysis.py).  "transient" runs (io/transient_io.py);
the other analysis types of the JAX package (modal, buckling, harmonic,
spectrum, continuation, plastic, random, reduction, identification,
sizing, reliability) are ROADMAP item 17.
"""

from __future__ import annotations

from typing import Dict

_KINDS = ("modal", "transient", "buckling", "harmonic", "spectrum",
          "continuation", "plastic", "random", "reduction",
          "identification", "sizing", "reliability")


def run_analysis(problem, analysis: Dict, device=None) -> Dict:
    """Run an "analysis" block on `device` ("cuda" when None)."""
    kind = analysis.get("type")
    if kind == "transient":
        from .transient_io import run_transient

        return run_transient(problem, analysis, device)
    if kind in _KINDS:
        raise NotImplementedError(
            f'"{kind}" analysis documents are not yet ported, ROADMAP '
            "item 17")
    raise ValueError(f'analysis.type must be "modal", "transient", '
                     f'"buckling", "harmonic", "spectrum", '
                     f'"continuation", "plastic", "random", "reduction", '
                     f'"identification", "sizing" or "reliability", '
                     f'got {kind!r}')
