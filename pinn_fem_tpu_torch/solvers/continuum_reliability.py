"""FORM reliability for the continuum families (counterpart of
pinn_fem_tpu/solvers/continuum_reliability.py): plane, solid, plate and
shell limit states on each family's differentiable dense statics, through
the shared driver solvers/reliability.form_core (marginal transforms,
Nataf copula, HL-RF, the unreachable-surface reset, Ditlevsen bounds,
crude Monte Carlo), one dense solve a row.

Variable kinds: young (element subsets), thickness (plane, plate and
shell; parsed through the truss parser's "area" slot), load_scale (the
whole consistent load vector) and resistance; density, area and inertia
are refused with the reason.  Limit states: {"type": "displacement",
"limit", "probe_dofs"} or {"type": "stress", "limit" | "variable",
"elements"}, the von Mises demand of each family's recovery (centroid for
plane and solid, extreme fiber for plates, the governing fiber of
N / t +- 6M / t^2 for shells).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..utils.runtime import default_dtype, resolve_device

_FAMILIES = ("plane", "solid", "plate", "shell")


def continuum_reliability(problem, variables: Sequence[Dict],
                          limit_state: Dict, family: str,
                          n_iter: int = 50, tol: float = 1e-4,
                          mc_samples: int = 0, mc_seed: int = 0,
                          correlation: Optional[Sequence] = None,
                          mesh=None, device=None):
    """FORM on a plane / solid / plate / shell problem (module docstring).
    mesh= (a device mesh) is ROADMAP item 15's multi-device row and raises.
    device: "cuda" when None.  Returns the shared ReliabilityResult."""
    from ..parallel import refuse_mesh
    from .reliability import (VariableMap, _nataf_cholesky,
                              _parse_variables, form_core, rowwise)

    if family not in _FAMILIES:
        raise ValueError(f"family must be one of {_FAMILIES}")
    m = problem.nelm
    alias, kinds = [], []
    for spec in variables or ():
        sp = dict(spec)
        kind = sp.get("kind")
        if kind == "density":
            raise ValueError('"density" does not enter continuum '
                             'statics — use young / thickness / '
                             'load_scale / resistance')
        if kind in ("area", "inertia"):
            raise ValueError(f'"{kind}" is not a continuum field — '
                             'use young / thickness / load_scale / '
                             'resistance')
        if kind == "thickness":
            if family == "solid":
                raise ValueError('a solid has no "thickness" field — '
                                 'use young / load_scale / resistance')
            sp["kind"] = "area"          # internal alias (same shape)
        kinds.append(kind)
        alias.append(sp)
    varspecs = _parse_variables(alias, m)
    for v, orig_kind in zip(varspecs, kinds):
        v["kind"] = orig_kind
    chol = _nataf_cholesky(varspecs, correlation)
    dev = resolve_device(device)
    dtype = default_dtype()
    vm = VariableMap(varspecs, chol, m, dtype, dev)
    var_names = [v["name"] for v in varspecs]

    ls = dict(limit_state or {})
    ls_type = ls.get("type", "displacement")
    res_var = None
    if ls_type == "displacement":
        if ls.get("limit") is None or ls.get("probe_dofs") is None:
            raise ValueError('continuum displacement limit state '
                             'needs "limit" and "probe_dofs"')
        limit = float(ls["limit"])
        probe = np.asarray(ls["probe_dofs"], dtype=int).reshape(-1)
        if probe.size and (probe.min() < 0
                           or probe.max() >= problem.ndof):
            raise ValueError("probe_dofs out of range")
        labels = [f"displacement dof{int(d)}" for d in probe]
    elif ls_type == "stress":
        if ls.get("variable") is not None:
            rn = ls["variable"]
            if rn not in var_names:
                raise ValueError(f"resistance variable {rn!r} is not "
                                 f"defined")
            res_var = var_names.index(rn)
            if varspecs[res_var]["kind"] != "resistance":
                raise ValueError(f'{rn!r} must have kind "resistance"')
            limit = None
        elif ls.get("limit") is not None:
            limit = float(ls["limit"])
        else:
            raise ValueError('continuum stress limit state needs '
                             '"limit" or "variable"')
        elems = ls.get("elements")
        probe = (np.arange(m) if elems is None
                 else np.asarray(elems, dtype=int).reshape(-1))
        if probe.size and (probe.min() < 0 or probe.max() >= m):
            raise ValueError("limit-state elements out of range")
        labels = [f"von Mises e{int(e)}" for e in probe]
    else:
        raise ValueError('continuum limit_state type must be '
                         '"displacement" or "stress"')
    refuse_mesh(mesh, "the Monte Carlo samples")
    probe_d = torch.as_tensor(probe, dtype=torch.int64, device=dev)

    def t(a):
        return torch.broadcast_to(torch.as_tensor(
            np.asarray(a, dtype=float), dtype=dtype, device=dev), (m,))

    young0 = t(problem.young)
    thick0 = None if family == "solid" else t(problem.thickness)

    def response(young, thickness, scale):
        kw = dict(young_e=young, load_scale=scale, dtype=dtype, device=dev)
        if family == "plane":
            from ..models.plane import plane_static_response

            return plane_static_response(problem, thickness_e=thickness,
                                         **kw)
        if family == "plate":
            from ..models.plate import plate_static_response

            return plate_static_response(problem, thickness_e=thickness,
                                         **kw)
        if family == "shell":
            from ..models.shell import shell_static_response

            return shell_static_response(problem, thickness_e=thickness,
                                         **kw)
        from ..models.solid import solid_static_response

        return solid_static_response(problem, **kw)

    def single(u):
        x = vm.physical(u[None])
        young = vm.field(x, "young", young0)[0]
        thickness = (None if thick0 is None
                     else vm.field(x, "thickness", thick0)[0])
        uu, _, von_mises = response(young, thickness, vm.load_scale(x)[0])
        if ls_type == "stress":
            r = x[0, res_var] if res_var is not None else limit
            return von_mises[probe_d] / r
        return torch.abs(uu)[probe_d] / limit

    return form_core(rowwise(single), varspecs, chol, labels,
                     n_iter=n_iter, tol=tol, mc_samples=mc_samples,
                     mc_seed=mc_seed, dtype=dtype, device=dev)


__all__ = ["continuum_reliability"]
