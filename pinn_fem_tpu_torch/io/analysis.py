"""Dispatch of a document's "analysis" block (counterpart of
pinn_fem_tpu/io/analysis.py).  "transient" (io/transient_io.py), "modal"
and "buckling" run; of the other analysis types of the JAX package,
harmonic, spectrum, continuation, plastic, random and reduction are
ROADMAP item 17, identification item 23, sizing and reliability item 24.

    "analysis": {"type": "modal", "n_modes": 6, "lumped": true,
                 "n_iter": 25, "include_shapes": true,
                 "prestress": true | {"loads": [..], "scale": s}
                            | {"u": [..]},    # initial-stress K_g(u0)
                 "damping_calibration": {"zeta": z | [z1, z2],
                                         "modes": [1, n]},
                 "compare_shapes": [[..ndof..], ..]}   # MAC rows

    "analysis": {"type": "buckling", "n_modes": 4, "include_shapes": true}
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ._common import _SHAPES_JSON_DOF_LIMIT, _prestress_state

# Analysis types whose runners are not yet ported, by ROADMAP item.
_NOT_PORTED = {"harmonic": 17, "spectrum": 17, "continuation": 17,
               "plastic": 17, "random": 17, "reduction": 17,
               "identification": 23, "sizing": 24, "reliability": 24}


def run_modal(problem, analysis: Dict, device=None) -> Dict:
    """A modal analysis block on `device`; a JSON-serializable dict."""
    from ..solvers.modal import mac, modal_analysis, rayleigh_coefficients

    # Clamp to the free-DOF count (UIs ask for a fixed mode count that
    # small models cannot supply).
    n_modes = min(int(analysis.get("n_modes", 6)),
                  problem.free_fixed()[0].size)
    lumped = bool(analysis.get("lumped", True))
    prestress_u = _prestress_state(problem, analysis.get("prestress"),
                                   device)
    res = modal_analysis(problem, n_modes=n_modes, lumped=lumped,
                         n_iter=int(analysis.get("n_iter", 25)),
                         prestress_u=prestress_u, device=device)
    out = {
        "success": True,
        "analysis": "modal",
        "n_modes": n_modes,
        "lumped": lumped,
        "prestressed": prestress_u is not None,
        # False: float32 could not resolve these modes (solvers/modal.py)
        # — consumers must not trust the frequencies.
        "ok": bool(res.ok),
        "eigenvalues": res.eigenvalues.tolist(),
        "omegas": res.omegas.tolist(),
        "frequencies_hz": res.frequencies.tolist(),
        "residuals": res.residuals.tolist(),
    }
    if analysis.get("include_shapes", problem.ndof <= _SHAPES_JSON_DOF_LIMIT):
        out["mode_shapes"] = res.shapes.T.tolist()     # (n_modes, ndof)
    cal = analysis.get("damping_calibration")
    if cal is not None:
        # Rayleigh (alpha, beta) from target damping ratios at two of the
        # computed modes: {"zeta": z} for one ratio, {"zeta": [z1, z2],
        # "modes": [1, 4]} per mode.
        zeta = cal.get("zeta", 0.05)
        if isinstance(zeta, (list, tuple)):
            if len(zeta) != 2:
                raise ValueError("damping_calibration.zeta must be a "
                                 "number or a [zeta_1, zeta_2] pair")
            z1, z2 = float(zeta[0]), float(zeta[1])
        else:
            z1 = z2 = float(zeta)
        modes = cal.get("modes", [1, n_modes])
        if (not isinstance(modes, (list, tuple)) or len(modes) != 2
                or any(int(m) != m for m in modes)):
            raise ValueError("damping_calibration.modes must be two "
                             "integer 1-based mode indices")
        m1, m2 = int(modes[0]), int(modes[1])
        if not (1 <= m1 < m2 <= n_modes):
            raise ValueError("damping_calibration.modes must be two "
                             f"distinct 1-based indices within the "
                             f"{n_modes} computed modes")
        w1, w2 = float(res.omegas[m1 - 1]), float(res.omegas[m2 - 1])
        alpha, beta = rayleigh_coefficients(w1, z1, w2, z2)
        out["rayleigh_damping"] = {
            "alpha": alpha, "beta": beta,
            "calibrated_at": {"omegas": [w1, w2], "zeta": [z1, z2]},
        }
    ref_shapes = analysis.get("compare_shapes")
    if ref_shapes is not None:
        # Test-vs-model shape correlation: the MAC matrix between the
        # computed shapes and supplied (n_ref, ndof) rows.
        ref = np.asarray(ref_shapes, dtype=float)
        if ref.ndim != 2 or ref.shape[1] != problem.ndof:
            raise ValueError(f"compare_shapes must be (n_ref, "
                             f"{problem.ndof}) rows")
        out["mac"] = mac(res.shapes, ref.T).tolist()
    return out


def run_buckling(problem, analysis: Dict, device=None) -> Dict:
    """A linearized-buckling block on `device`: the problem's loads define
    the base pattern and load_factors scale it (solvers/buckling.py)."""
    from ..solvers.buckling import buckling_analysis

    res = buckling_analysis(problem, n_modes=int(analysis.get("n_modes", 4)),
                            device=device)
    lam = [None if not np.isfinite(v) else float(v)
           for v in res.load_factors]    # inf -> null in JSON
    out = {
        "success": True,
        "analysis": "buckling",
        "n_modes": len(lam),
        # False: the banded float32 path could not converge the Ritz
        # values — consumers must not trust the factors.
        "ok": bool(res.ok),
        "load_factors": lam,
        "axial_forces": res.axial_forces.tolist(),
        "u_base": res.u_base.tolist(),
    }
    if analysis.get("include_shapes", problem.ndof <= _SHAPES_JSON_DOF_LIMIT):
        out["buckling_modes"] = res.modes.T.tolist()
    return out


def run_analysis(problem, analysis: Dict, device=None) -> Dict:
    """Run an "analysis" block on `device` ("cuda" when None)."""
    kind = analysis.get("type")
    if kind == "transient":
        from .transient_io import run_transient

        return run_transient(problem, analysis, device)
    if kind == "modal":
        return run_modal(problem, analysis, device)
    if kind == "buckling":
        return run_buckling(problem, analysis, device)
    if kind in _NOT_PORTED:
        raise NotImplementedError(
            f'"{kind}" analysis documents are not yet ported, ROADMAP '
            f"item {_NOT_PORTED[kind]}")
    raise ValueError(f'analysis.type must be "modal", "transient", '
                     f'"buckling", "harmonic", "spectrum", '
                     f'"continuation", "plastic", "random", "reduction", '
                     f'"identification", "sizing" or "reliability", '
                     f'got {kind!r}')
