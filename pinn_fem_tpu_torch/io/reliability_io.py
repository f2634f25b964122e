"""Reliability ("analysis": {"type": "reliability"}) JSON runner
(counterpart of pinn_fem_tpu/io/reliability_io.py): FORM / SORM failure
probabilities under uncertain material, load and resistance, with Nataf
correlation, random fields and Monte-Carlo validation
(solvers/reliability.form_reliability), with the JAX package's contract
(its run_reliability docstring is the full reference).  Dense-only.  The
JAX package runs it on its local CPU backend unless "on_device": true;
the port reads the key and ignores it: it runs on its device ("cuda" when
None).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ._common import (_SHAPES_JSON_DOF_LIMIT, _json_finite, _omega_array,
                      _probe_dofs)


def run_reliability(problem, analysis: Dict, device=None) -> Dict:
    """Execute a reliability block on `device`; a JSON-serializable dict."""
    from ..solvers.reliability import form_reliability

    ls = dict(analysis.get("limit_state") or {})
    if ls.get("type", "stress") == "displacement" \
            and ("probe_nodes" in ls or "probe_dofs" in ls):
        ls["probe_dofs"] = _probe_dofs(ls, problem).tolist()
    if ls.get("type") == "fatigue":
        if isinstance(ls.get("fatigue"), dict):
            ls["fatigue"] = dict(ls["fatigue"])
            if "omegas" in ls["fatigue"]:
                ls["fatigue"]["omegas"] = \
                    _omega_array(ls["fatigue"]["omegas"])
        if ls.get("min_life_s") is None \
                and ls.get("min_life_hours") is not None:
            ls["min_life_s"] = 3600.0 * float(ls.pop("min_life_hours"))
    res = form_reliability(
        problem, analysis.get("variables"), ls,
        n_iter=int(analysis.get("n_iter", 50)),
        mc_samples=int(analysis.get("validate_mc", 0)),
        mc_seed=int(analysis.get("seed", 0)),
        mc_method=analysis.get("mc_method", "crude"),
        sorm=bool(analysis.get("sorm", False)),
        correlation=analysis.get("correlation"), device=device)
    worst = int(np.argmin(res.beta)) if res.beta.size else -1
    out = {
        "success": True,
        "analysis": "reliability",
        "labels": res.labels,
        "variables": res.variables,
        "beta": [None if not np.isfinite(v) else float(v)
                 for v in res.beta],     # inf = unreachable surface
        "pf": res.pf.tolist(),
        "alpha": res.alpha.tolist(),
        "design_points": res.design_point.tolist(),
        "converged": [bool(v) for v in res.converged],
        "critical_limit_state": worst,
        "beta_min": float(res.beta[worst]) if worst >= 0 else None,
        "system_pf_bounds": [res.system_pf_lower, res.system_pf_upper],
        "system_pf_ditlevsen_bounds": [res.system_pf_ditlevsen_lower,
                                       res.system_pf_ditlevsen_upper],
    }
    if analysis.get("include_correlation",
                    len(res.labels) <= _SHAPES_JSON_DOF_LIMIT):
        out["alpha_correlation"] = res.alpha_correlation.tolist()
    if res.pf_sorm is not None:
        out["pf_sorm"] = res.pf_sorm.tolist()
        out["system_pf_sorm_bounds"] = [res.system_pf_sorm_lower,
                                        res.system_pf_sorm_upper]
    if res.mc_pf is not None:
        out["mc"] = {"pf": res.mc_pf, "std_error": res.mc_std_error,
                     "n_samples": res.mc_n, "method": res.mc_method,
                     "pf_per_limit_state": res.mc_pf_per_ls.tolist()}
    return _json_finite(out)
