"""Shared parsing and output of the api_* process entry points
(counterpart of pinn_fem_tpu/cli/_api_common.py).

These CLIs keep the reference's Node-facing JSON protocols: argv
[input.json, output.json], dict-format 2D nodes, element stress and strain
from deformed geometry, and {error, type} with exit 1 on failure.  The
device comes from PINN_FEM_TORCH_DEVICE (default "cuda"), as in
cli/generic.py; asking for CUDA without a card is an error.
"""

from __future__ import annotations

import json
import os
import sys
import traceback
from typing import Dict, Tuple

import numpy as np

from ..models.fields import Material, to_field
from ..models.problem import TrussProblem
from ..utils.runtime import resolve_device


def parse_nodes_2d(input_data: Dict) -> Tuple[np.ndarray, np.ndarray]:
    """Dict-format nodes -> (coords (n, 2), fixed_dofs).

    Keeps the reference's elif quirk: a node with BOTH fixed_x and fixed_y
    (but not "fixed") locks x only.
    """
    nodes = np.array([[n["x"], n["y"]] for n in input_data["nodes"]],
                     dtype=float)
    fixed = []
    for i, node in enumerate(input_data["nodes"]):
        if node.get("fixed", False):
            fixed.extend([2 * i, 2 * i + 1])
        elif node.get("fixed_x", False):
            fixed.append(2 * i)
        elif node.get("fixed_y", False):
            fixed.append(2 * i + 1)
    return nodes, np.array(fixed, dtype=int)


def parse_elements_obj(input_data: Dict) -> np.ndarray:
    return np.array(
        [[e["nodes"][0], e["nodes"][1]] for e in input_data["elements"]],
        dtype=int)


def build_problem_2d(input_data: Dict, young: float, area: float,
                     density: float = 7850.0) -> TrussProblem:
    nodes, fixed_dofs = parse_nodes_2d(input_data)
    elements = parse_elements_obj(input_data)
    loads = np.array(input_data.get("loads", [0.0] * (2 * len(nodes))),
                     dtype=float)
    material = Material(young=to_field(young), area=to_field(area),
                        density=to_field(density))
    return TrussProblem(nodes, elements, material, loads, fixed_dofs,
                        dimension=2)


def measurements(input_data: Dict) -> Tuple[np.ndarray, np.ndarray]:
    """(measured_disp, measured_dofs) of a scalar identification input;
    both are required."""
    measured_disp = input_data.get("measured_disp", [])
    measured_dofs = input_data.get("measured_dofs", [])
    if not measured_disp or not measured_dofs:
        raise ValueError(
            "PINN requires measured_disp and measured_dofs for inverse "
            "problem")
    return (np.asarray(measured_disp, dtype=float),
            np.asarray(measured_dofs, dtype=int))


def element_stresses_2d(nodes: np.ndarray, elements: np.ndarray,
                        u_flat: np.ndarray, young: float):
    """Engineering strain and stress from deformed geometry:
    eps = (L - L0) / L0, sigma = E eps, per element (float64, numpy)."""
    i, j = elements[:, 0], elements[:, 1]
    u = np.asarray(u_flat, dtype=float).reshape(-1, 2)
    l0 = np.hypot(*(nodes[j] - nodes[i]).T)
    l_def = np.hypot(*((nodes[j] + u[j]) - (nodes[i] + u[i])).T)
    strains = (l_def - l0) / l0
    return (young * strains).tolist(), strains.tolist()


def api_main(parse_and_solve, argv=None, usage: str = "") -> int:
    """argv protocol and error-JSON contract shared by the api_* CLIs:
    parse_and_solve(input_data, device) -> output dict.  Any exception
    (a kernel's failure on the card included) writes {error, type},
    prints the traceback and returns 1."""
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 2:
        print(usage)
        return 1
    input_file, output_file = argv
    print(f"Reading input from {input_file}")
    try:
        device = resolve_device(
            os.environ.get("PINN_FEM_TORCH_DEVICE", "cuda"))
        with open(input_file, "r") as f:
            input_data = json.load(f)
        output = parse_and_solve(input_data, device)
        with open(output_file, "w") as f:
            json.dump(output, f, indent=2)
        print(f"[OK] Results written to {output_file}")
        return 0
    except Exception as e:  # contract: {error, type}, exit 1
        with open(output_file, "w") as f:
            json.dump({"error": str(e), "type": type(e).__name__}, f,
                      indent=2)
        print(f"[ERROR] {e}")
        traceback.print_exc()
        return 1
