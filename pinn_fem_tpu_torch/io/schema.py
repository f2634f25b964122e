"""Problem-JSON parsing for truss documents (counterpart of
pinn_fem_tpu/io/schema.py).

Input variants kept: nodes as coordinate lists (true-1D [[x], ...]
flattens) or dicts with x/y[/z] and fixed/fixed_x/fixed_y flags; elements
as [[i, j], ...] or [{"nodes": [i, j]}, ...]; fixed_dofs directly, else
from the node flags; the three measured-displacement formats; nn_config
per property with the hidden_layers/hiddenLayers and
neurons_per_layer/neuronsPerLayer aliases.  Method precedence:
solver_config.method, then the solver_type mapping; pinn_config and
solver_config keys with the reference's precedence (learning rates prefer
solver_config, everything else prefers pinn_config).

NN fields draw their initial weights as the JAX package does, from
jax.random.PRNGKey(seed * 1000 + k) (k = 0, 1, 2 for young, area,
density) reproduced in numpy (utils/prng.py), so both CLIs start from the
same weights.

Two extensions of the JAX package's schema: a "thermal" block
{"alpha", "delta_t"} whose equivalent loads (ops/thermal.py) join the load
vector at parse time, evaluated on the CPU (parsing never touches a card);
and a "prescribed_displacements" block {"dofs", "values"} (support
settlement), whose DOFs become fixed and whose values reach
solve_nr(prescribed_u=...) through `ParsedProblem.prescribed`.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

from ..config import SolverConfig
from ..models.fields import Material, make_mlp_field, to_field
from ..models.problem import TrussProblem
from ..utils import prng

_PROPERTY_DEFAULTS = {"young": 210e9, "area": 0.01, "density": 7850.0}


@dataclass
class ParsedProblem:
    problem: TrussProblem
    config: SolverConfig
    measured_disp: Optional[np.ndarray] = None
    measured_dofs: Optional[np.ndarray] = None
    # {solver_type, description, analysis, thermal}: the document's
    # routing keys, as the JAX package's ParsedProblem.meta holds them.
    meta: Dict = field(default_factory=dict)
    prescribed: Optional[np.ndarray] = None  # (ndof,) settlement values


def _parse_nodes(nodes_list):
    """(nodes array for TrussProblem, problem_dim, is_dict_format)."""
    if nodes_list and isinstance(nodes_list[0], list):
        arr = np.array(nodes_list, dtype=float)
        dim = arr.shape[1]
        if dim == 1:
            return arr.flatten(), 1, False
        return arr, dim, False
    if any("z" in n for n in nodes_list):
        nodes = np.array(
            [[n["x"], n["y"], n.get("z", 0.0)] for n in nodes_list], dtype=float
        )
        return nodes, 3, True
    nodes = np.array([[n["x"], n["y"]] for n in nodes_list], dtype=float)
    return nodes, 2, True


def _parse_elements(elements_data):
    if elements_data and isinstance(elements_data[0], list):
        return np.array(elements_data, dtype=int)
    return np.array([[e["nodes"][0], e["nodes"][1]] for e in elements_data],
                    dtype=int)


def _parse_fixed_dofs(data, nodes_list, dim: int = 2):
    fixed = data.get("fixed_dofs", [])
    if fixed:
        return np.array(fixed, dtype=int)
    out = []
    if nodes_list and isinstance(nodes_list[0], dict):
        for i, node in enumerate(nodes_list):
            if node.get("fixed", False):
                out.extend(dim * i + c for c in range(dim))
            else:
                for c, axis in enumerate(("x", "y", "z")[:dim]):
                    if node.get(f"fixed_{axis}", False):
                        out.append(dim * i + c)
    return np.array(out, dtype=int)


def _parse_measured(data, nodes_list, dim: int = 2):
    dofs, values = [], []
    axes = ("x", "y", "z")[:dim]
    measured = data.get("measured_displacements", None)
    if measured:
        if "global_dof" in measured and "measured_u" in measured:
            dofs = list(measured["global_dof"])
            values = list(measured["measured_u"])
        else:
            m_nodes = measured.get("nodes", [])
            for idx, node_id in enumerate(m_nodes):
                for c, axis in enumerate(axes):
                    comp = measured.get(f"u{axis}", [])
                    if idx < len(comp):
                        dofs.append(dim * node_id + c)
                        values.append(comp[idx])
    else:
        for i, node in enumerate(nodes_list):
            if not isinstance(node, dict):
                continue
            for c, axis in enumerate(axes):
                v = node.get(f"measured_u{axis}", 0)
                if v != 0:
                    dofs.append(dim * i + c)
                    values.append(v)
    return np.array(dofs, dtype=int), np.array(values, dtype=float)


def _build_material(data, seed: int) -> Material:
    material_data = data.get("material", {})
    nn_config = data.get("nn_config", {})
    fields = {}
    for k, prop in enumerate(("young", "area", "density")):
        base = material_data.get(prop, _PROPERTY_DEFAULTS[prop])
        cfg = nn_config.get(prop, {})
        if cfg.get("enabled", False):
            fields[prop] = make_mlp_field(
                prng.PRNGKey(seed * 1000 + k),
                hidden_layers=cfg.get("hidden_layers", cfg.get("hiddenLayers", 2)),
                neurons_per_layer=cfg.get(
                    "neurons_per_layer", cfg.get("neuronsPerLayer", 20)
                ),
                input_dim=cfg.get("input_dim", 1),
                scale=base,
                enforce_positive=True,
            )
        else:
            fields[prop] = to_field(base)
    return Material(**fields)


def parse_problem_dict(data: Dict, seed: int = 0) -> ParsedProblem:
    nodes_list = data.get("nodes", [])
    nodes, problem_dim, _ = _parse_nodes(nodes_list)
    elements = _parse_elements(data.get("elements", []))
    fixed_dofs = _parse_fixed_dofs(data, nodes_list, problem_dim)

    n_nodes = len(nodes_list)
    n_dofs = n_nodes * problem_dim
    loads = np.array(data.get("loads", [0.0] * n_dofs), dtype=float)

    material = _build_material(data, seed)
    solver_type = data.get("solver_type", "auto")

    measured_disp = measured_dofs = None
    if solver_type.startswith("pinn"):
        measured_dofs, measured_disp = _parse_measured(data, nodes_list,
                                                       problem_dim)

    # Non-structural point masses: a full per-node table, or
    # [[node, mass], ...] pairs.
    point_masses = None
    pm_spec = data.get("point_masses")
    if pm_spec is not None:
        arr = np.asarray(pm_spec, dtype=float)
        if arr.ndim == 2 and arr.shape[1] == 2:
            point_masses = np.zeros(n_nodes)
            idx = arr[:, 0]
            if np.any(idx != np.round(idx)) or np.any(idx < 0) \
                    or np.any(idx >= n_nodes):
                raise ValueError("point_masses pairs need valid node "
                                 "indices")
            np.add.at(point_masses, idx.astype(int), arr[:, 1])
        elif arr.ndim == 1:
            point_masses = arr
        else:
            raise ValueError("point_masses must be a per-node list or "
                             "[node, mass] pairs")

    problem = TrussProblem(
        nodes=nodes,
        elements=elements,
        material=material,
        loads=loads,
        fixed_dofs=fixed_dofs,
        dimension=problem_dim,
        point_masses=point_masses,
    )

    thermal = data.get("thermal")
    if thermal:
        if material.has_trainable_params:
            # f_th would be frozen at the initial field values, and an
            # inverse solve would identify against a stale thermal load.
            raise ValueError(
                "thermal loading with trainable (NN) material fields is "
                "not supported: the equivalent loads E A alpha dT would "
                "be frozen at the initial field values")
        from ..ops.thermal import element_delta_t, thermal_loads

        tdata = problem.to_device("cpu")
        dt_e = element_delta_t(tdata, thermal["delta_t"], n_nodes)
        f_th = thermal_loads(tdata, material, thermal.get("alpha", 1.0), dt_e)
        problem.loads = problem.loads + f_th.numpy().astype(float)

    prescribed = None
    pd = data.get("prescribed_displacements")
    if pd:
        pdofs = np.asarray(pd["dofs"], dtype=int)
        pvals = np.asarray(pd["values"], dtype=float)
        if pdofs.shape != pvals.shape:
            raise ValueError("prescribed dofs/values length mismatch")
        prescribed = np.zeros(n_dofs)
        prescribed[pdofs] = pvals
        extra = np.setdiff1d(pdofs, problem.fixed_dofs)
        if extra.size:  # prescribing a DOF fixes it
            problem.fixed_dofs = np.sort(
                np.concatenate([problem.fixed_dofs, extra]))

    sc = data.get("solver_config", {})
    pc = data.get("pinn_config", {})

    explicit = sc.get("method", None)
    if explicit:
        method = explicit
    elif solver_type == "fem":
        method = "nr"
    elif solver_type in ("pinn-gd", "pinn"):
        method = "gd"
    elif solver_type == "pinn-hybrid":
        method = "hybrid"
    else:
        method = "auto"

    config = SolverConfig(
        max_iterations=pc.get("max_iterations", sc.get("max_iterations", 1000)),
        tolerance=pc.get("tolerance", sc.get("tolerance", 1e-6)),
        print_every=pc.get("print_every", 10),
        n_increments=sc.get("n_increments", 10),
        min_denominator=sc.get("min_denominator", 1e-10),
        learning_rate_u=sc.get("learning_rate_u", pc.get("learning_rate_u", 1e-7)),
        learning_rate_theta=sc.get(
            "learning_rate_theta", pc.get("learning_rate_theta", 1e-4)
        ),
        alpha_physics=pc.get("alpha_physics", 1.0),
        alpha_data=pc.get("alpha_data", 100.0),
        preconditioning=pc.get("preconditioning", sc.get("preconditioning", False)),
        method=method,
        seed=seed,
    )

    return ParsedProblem(
        problem=problem,
        config=config,
        measured_disp=measured_disp,
        measured_dofs=measured_dofs,
        meta={
            "solver_type": solver_type,
            "description": data.get("description", ""),
            "analysis": data.get("analysis"),
            "thermal": thermal,
        },
        prescribed=prescribed,
    )


def parse_problem_file(path, seed: int = 0) -> ParsedProblem:
    with open(path, "r") as f:
        return parse_problem_dict(json.load(f), seed=seed)
