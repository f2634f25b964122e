"""Result serialization and identified-property extraction (counterpart
of pinn_fem_tpu/io/results.py).

  * the output dict is {success, converged, iterations = len(history),
    displacements, reactions, history, nn_parameters?,
    identified_properties?} (reference generic.py:476-495);
  * identified_properties evaluates every NN field at the nodes and the
    element centroids; a field with input_dim > the problem's dimension is
    load-factor-aware and is evaluated at load factors 0.2, 0.5 and 1.0
    under "load_factor_variations" (generic.py:498-799).

The fields are evaluated in their torch form (`eval_batch`) on the device
their weights lie on: the JAX package evaluates them outside its kernel
too.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..config import SolverResult
from ..models.fields import (
    MLPField,
    ScalarField,
    point_inputs_dict_order,
    point_inputs_direct,
)
from ..models.problem import TrussProblem

_LOAD_FACTORS = (0.2, 0.5, 1.0)


def _eval_field_values(field: MLPField, x) -> List[float]:
    return [float(v) for v in field.eval_batch(x).detach().cpu().numpy()]


def _coords_tolist(coords: np.ndarray, dimension: int):
    if dimension == 1:
        return [float(c) for c in np.asarray(coords).reshape(-1)]
    return np.asarray(coords).tolist()


def _at_points(field: MLPField, node_x, elem_x, node_coords, centroids,
               dim: int) -> Dict:
    return {
        "at_nodes": {"coords": _coords_tolist(node_coords, dim),
                     "values": _eval_field_values(field, node_x)},
        "at_elements": {"centroids": _coords_tolist(centroids, dim),
                        "values": _eval_field_values(field, elem_x)},
    }


def extract_identified_properties(problem: TrussProblem, load_factors=None
                                  ) -> Dict:
    load_factors = load_factors or _LOAD_FACTORS
    dim = problem.dimension
    node_coords = problem.node_coords_2d                        # (nnode, dim)
    centroids = problem.element_midpoints()                     # (nelm, dim)
    nodes_out = problem.nodes if dim == 1 else node_coords

    props: Dict = {}
    for name in ("young", "area", "density"):
        field = getattr(problem.material, name)
        if isinstance(field, ScalarField):
            props[name] = {"value": field.eval_scalar(), "type": "scalar"}
            continue
        dev = field.scale.device
        if field.input_dim > dim:
            # Load-factor-aware: (load_factor, x[, y]) rows.
            props[name] = {
                "load_factor_variations": {
                    f"load_factor_{lf:.1f}": _at_points(
                        field,
                        point_inputs_dict_order(node_coords, dim, lf,
                                                device=dev),
                        point_inputs_dict_order(centroids, dim, lf,
                                                device=dev),
                        nodes_out, centroids, dim)
                    for lf in load_factors},
                "type": "nn_load_dependent",
                "input_dim": field.input_dim,
            }
        else:
            # Spatial only: coordinates zero-padded to input_dim.
            props[name] = {
                **_at_points(
                    field,
                    point_inputs_direct(node_coords, field.input_dim,
                                        device=dev),
                    point_inputs_direct(centroids, field.input_dim,
                                        device=dev),
                    nodes_out, centroids, dim),
                "type": "nn",
                "input_dim": field.input_dim,
            }
    return props


def result_to_output_dict(result: SolverResult,
                          problem: Optional[TrussProblem] = None) -> Dict:
    output = {
        "success": result.converged,
        "converged": result.converged,
        "iterations": len(result.history),
        "displacements": np.asarray(result.displacements).flatten().tolist(),
        "reactions": (
            np.asarray(result.reactions).flatten().tolist()
            if result.reactions is not None
            else []
        ),
        "history": result.history,
    }
    if result.nn_parameters:
        output["nn_parameters"] = {
            k: np.asarray(v).tolist() for k, v in result.nn_parameters.items()
        }
        if problem is not None:
            output["identified_properties"] = extract_identified_properties(
                problem)
    return output
