"""Structured test meshes: the cross-braced grid and the straight chain.

The same generators as benchmarks/scaling.py (grid_problem, chain_problem),
so the port's large-mesh runs use the JAX package's own benchmark meshes.
The 100 x 200 grid (40,000 DOFs, 79,102 elements) is the repository's
large-mesh Newton figure; the 1,000,001-node chain (2,000,002 DOFs, 7
diagonals) is its matvec and CG-iteration figure.  `pinn_grid_document`
makes the grid a PINN identification document (three MLP fields, measured
displacements), the large-mesh figure of the GD path;
`thermal_grid_document` and `settlement_grid_document` make it a thermal
and a support-settlement document, with float64 references
(`float64_thermal_loads`, `float64_solution(..., prescribed)`,
`float64_reference` for a whole document), and
`float64_green_lagrange_force` recomputes the Green-Lagrange internal
force from a solution.  `shuffled_document` renumbers any of these
documents' nodes by a seeded random permutation: the same mesh, whose
numbering gives no banded layout (the gather-based PCG's case).
`transient_grid_document` makes the grid a transient analysis document,
`strip_problem` a slender guided strip numbered along its length (where
Jacobi-PCG needs O(n) iterations), and
`float64_transient` integrates such a document's central-difference
or Newmark recurrence in float64 on scipy's sparse K (Newmark with one
sparse LU of its effective stiffness).  `plane_strip_document` is the
JAX package's banded plane benchmark as a document (a Q4 strip in
uniaxial tension, benchmarks/scaling.py's plane_section: 128 x 512 is
132,354 DOFs), `plane_annulus_document` the corpus thick-wall cylinder
(dyn-plane-plastic.json) at any mesh, and `plane_sparse_matrices` the
float64 scipy K and M of a plane problem from the port's element blocks.
"""

from __future__ import annotations

import numpy as np

from .models.fields import Material
from .models.problem import TrussProblem


def grid_arrays(rows: int, cols: int):
    """(nodes, elements, loads, fixed_dofs) of a cross-braced grid strip in
    tension: the left edge is pinned and the right edge pulled along x.
    Node ids run row-major, so the stiffness is banded with ~2 * cols
    bandwidth."""
    ys, xs = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    nodes = np.stack([xs.ravel(), ys.ravel()], axis=1).astype(float)
    nid = np.arange(rows * cols).reshape(rows, cols)
    # Per node, the element order of benchmarks/scaling.py: right,
    # down, down-right diagonal, then the crossing diagonal.
    pairs = np.full((rows, cols, 4, 2), -1, dtype=np.int64)
    pairs[:, :-1, 0] = np.stack([nid[:, :-1], nid[:, 1:]], -1)
    pairs[:-1, :, 1] = np.stack([nid[:-1, :], nid[1:, :]], -1)
    pairs[:-1, :-1, 2] = np.stack([nid[:-1, :-1], nid[1:, 1:]], -1)
    pairs[:-1, :-1, 3] = np.stack([nid[:-1, 1:], nid[1:, :-1]], -1)
    pairs = pairs.reshape(-1, 2)
    elements = pairs[pairs[:, 0] >= 0]
    loads = np.zeros(2 * rows * cols)
    loads[2 * nid[:, -1]] = 1.0
    fixed = np.stack([2 * nid[:, 0], 2 * nid[:, 0] + 1], axis=1).reshape(-1)
    return nodes, elements, loads, fixed


def grid_problem(rows: int, cols: int) -> TrussProblem:
    nodes, elements, loads, fixed = grid_arrays(rows, cols)
    return TrussProblem(nodes=nodes, elements=elements,
                        material=Material(young=1.0, area=1.0, density=1.0),
                        loads=loads, fixed_dofs=fixed, dimension=2)


def grid_document(rows: int, cols: int, tolerance: float = 1e-5,
                  n_increments: int = 2, max_iterations: int = 20) -> dict:
    """The grid as a JSON problem document for the CLI (method "nr")."""
    nodes, elements, loads, fixed = grid_arrays(rows, cols)
    return {
        "description": f"cross-braced {rows}x{cols} grid strip in tension",
        "nodes": nodes.tolist(),
        "elements": elements.tolist(),
        "fixed_dofs": fixed.tolist(),
        "loads": loads.tolist(),
        "material": {"young": 1.0, "area": 1.0, "density": 1.0},
        "solver_type": "fem",
        "solver_config": {"method": "nr", "tolerance": tolerance,
                          "n_increments": n_increments,
                          "max_iterations": max_iterations},
    }


def grid_delta_t(rows: int, cols: int, top: float) -> np.ndarray:
    """Per-node temperature change of the grid: 0 on the bottom row, rising
    linearly to `top` on the top row."""
    return np.repeat(np.linspace(0.0, top, rows), cols)


def thermal_grid_document(rows: int, cols: int, alpha: float = 1e-2,
                          top: float = 50.0, **config) -> dict:
    """The grid document (`grid_document`) with a "thermal" block: a
    per-node temperature gradient (`grid_delta_t`), so alpha dT runs from 0
    at the bottom row to alpha * top at the top row."""
    doc = grid_document(rows, cols, **config)
    doc["description"] += ", heated from the bottom row up"
    doc["thermal"] = {"alpha": alpha,
                      "delta_t": grid_delta_t(rows, cols, top).tolist()}
    return doc


def settlement_grid_document(rows: int, cols: int, settlement: float = 0.01,
                             top_load: float = -1e-4, **config) -> dict:
    """The grid document with its right edge's x-DOFs prescribed to
    `settlement` (they become fixed) and the loads replaced by `top_load`
    on each top-row node's y-DOF (zero: settlement only)."""
    doc = grid_document(rows, cols, **config)
    nid = np.arange(rows * cols).reshape(rows, cols)
    loads = np.zeros(2 * rows * cols)
    loads[2 * nid[-1, 1:] + 1] = top_load
    doc["description"] += ", right edge settled"
    doc["loads"] = loads.tolist()
    doc["prescribed_displacements"] = {
        "dofs": (2 * nid[:, -1]).tolist(),
        "values": [settlement] * rows}
    return doc


def shuffled_document(doc: dict, seed: int = 0):
    """(document, order): a 2D truss document with its nodes renumbered by
    a seeded random permutation, order[new] = old node id.  Loads, fixed,
    prescribed and measured DOFs and a per-node temperature change follow
    their nodes; the element order is kept.
    ops.reorder.restore_field(field, order, 2) maps a per-DOF field of the
    result back to the original numbering."""
    nnode = len(doc["nodes"])
    order = np.random.default_rng(seed).permutation(nnode)
    new_of_old = np.empty(nnode, dtype=np.int64)
    new_of_old[order] = np.arange(nnode)
    new_dof = (2 * new_of_old[:, None] + np.arange(2)).reshape(-1)

    def dofs(ids):
        return new_dof[np.asarray(ids, dtype=np.int64)].tolist()

    out = dict(doc)
    out["nodes"] = np.asarray(doc["nodes"], float)[order].tolist()
    out["elements"] = new_of_old[np.asarray(doc["elements"])].tolist()
    loads = np.asarray(doc["loads"], float)
    out["loads"] = loads[(2 * order[:, None] + np.arange(2)).reshape(-1)
                         ].tolist()
    out["fixed_dofs"] = sorted(dofs(doc["fixed_dofs"]))
    if "thermal" in doc and np.ndim(doc["thermal"]["delta_t"]) == 1 \
            and len(doc["thermal"]["delta_t"]) == nnode:
        out["thermal"] = dict(doc["thermal"], delta_t=np.asarray(
            doc["thermal"]["delta_t"], float)[order].tolist())
    if "prescribed_displacements" in doc:
        pd = doc["prescribed_displacements"]
        out["prescribed_displacements"] = dict(pd, dofs=dofs(pd["dofs"]))
    if "measured_displacements" in doc:
        md = doc["measured_displacements"]
        out["measured_displacements"] = dict(md,
                                             global_dof=dofs(md["global_dof"]))
    return out, order


def chain_problem(n_nodes: int) -> TrussProblem:
    """Straight 2D chain, pinned at node 0, pulled at the free end."""
    nodes = np.stack([np.arange(n_nodes, dtype=float), np.zeros(n_nodes)], 1)
    elements = np.stack([np.arange(n_nodes - 1), np.arange(1, n_nodes)], 1)
    loads = np.zeros(2 * n_nodes)
    loads[-2] = 1.0
    return TrussProblem(nodes=nodes, elements=elements,
                        material=Material(young=1.0, area=1.0, density=1.0),
                        loads=loads, fixed_dofs=np.array([0, 1]), dimension=2)


def strip_problem(length: int) -> TrussProblem:
    """A cross-braced strip two nodes wide and `length` nodes long,
    numbered along its length (node 2 r + c at row r, column c, so the
    stiffness has offsets within +-7), clamped at row 0, pulled along its
    axis (y) at the last row, every node's lateral (x) DOF held by a
    roller: the slender axial case, cond ~ length^2, where Jacobi-PCG
    needs O(length) iterations.  Without the rollers the strip is a beam
    whose bending gives cond ~ length^4, past what float32 resolves (at
    length 500 neither PCG reached tol 1e-6 on the CPU)."""
    nodes, elements, _, _ = grid_arrays(length, 2)
    ndof = 2 * nodes.shape[0]
    loads = np.zeros(ndof)
    loads[[-3, -1]] = 1.0                 # y of the last row's two nodes
    fixed = np.union1d(np.arange(4), np.arange(0, ndof, 2))
    return TrussProblem(nodes=nodes, elements=elements,
                        material=Material(young=1.0, area=1.0, density=1.0),
                        loads=loads, fixed_dofs=fixed, dimension=2)


def _dofs_2d(el) -> np.ndarray:
    """(nelm, 4) global DOFs of 2D elements [[i, j], ...]."""
    return np.concatenate([2 * el[:, :1], 2 * el[:, :1] + 1,
                           2 * el[:, 1:], 2 * el[:, 1:] + 1], axis=1)


def float64_stiffness(nodes, elements):
    """K of a 2D truss with E = A = 1, float64 scipy CSR."""
    import scipy.sparse as sp

    nodes = np.asarray(nodes, float)
    el = np.asarray(elements)
    ndof = 2 * nodes.shape[0]
    dx = nodes[el[:, 1]] - nodes[el[:, 0]]
    length = np.linalg.norm(dx, axis=1)
    g = np.concatenate([-dx, dx], axis=1) / length[:, None]
    dof = _dofs_2d(el)
    ke = g[:, :, None] * g[:, None, :] / length[:, None, None]
    return sp.coo_matrix((ke.ravel(), (np.repeat(dof, 4, 1).ravel(),
                                       np.tile(dof, (1, 4)).ravel())),
                         shape=(ndof, ndof)).tocsr()


def float64_thermal_loads(nodes, elements, alpha: float,
                          delta_t_nodes) -> np.ndarray:
    """f_th = sum_e alpha dT_e g_e of a 2D truss with E = A = 1 in float64,
    dT_e the mean of the element's two node values."""
    nodes, el = np.asarray(nodes, float), np.asarray(elements)
    dt_n = np.asarray(delta_t_nodes, float)
    dx = nodes[el[:, 1]] - nodes[el[:, 0]]
    g = np.concatenate([-dx, dx], axis=1) / np.linalg.norm(
        dx, axis=1)[:, None]
    coef = alpha * 0.5 * (dt_n[el[:, 0]] + dt_n[el[:, 1]])
    dof = _dofs_2d(el)
    f = np.zeros(2 * nodes.shape[0])
    np.add.at(f, dof, coef[:, None] * g)
    return f


def float64_green_lagrange_force(nodes, elements, u) -> np.ndarray:
    """Internal force of a 2D truss with E = A = 1 under Green-Lagrange
    kinematics, in float64: sum_e (1/L0) e_gl d_e, d_e = [-dx, dx] the
    deformed chord, e_gl = (dx0.delta + |delta|^2 / 2) / L0^2."""
    nodes, el = np.asarray(nodes, float), np.asarray(elements)
    u2 = np.asarray(u, float).reshape(-1, 2)
    dx0 = nodes[el[:, 1]] - nodes[el[:, 0]]
    delta = u2[el[:, 1]] - u2[el[:, 0]]
    l0_sq = np.sum(dx0 * dx0, axis=1)
    e_gl = (np.sum(dx0 * delta, axis=1)
            + 0.5 * np.sum(delta * delta, axis=1)) / l0_sq
    dx = dx0 + delta
    fe = (e_gl / np.sqrt(l0_sq))[:, None] * np.concatenate([-dx, dx], 1)
    dof = _dofs_2d(el)
    f = np.zeros(2 * nodes.shape[0])
    np.add.at(f, dof, fe)
    return f


def float64_solution(nodes, elements, loads, fixed_dofs,
                     prescribed=None) -> np.ndarray:
    """Displacements of a 2D truss with E = A = 1 by a float64 sparse
    direct solve (scipy): K_ff u_f = f_f - K_fp u_p, where u_p, the
    fixed DOFs' values, is `prescribed` (ndof,) or zero."""
    import scipy.sparse.linalg as spl

    k = float64_stiffness(nodes, elements)
    f = np.asarray(loads, float)
    u = (np.zeros(f.size) if prescribed is None
         else np.asarray(prescribed, float).copy())
    free = np.setdiff1d(np.arange(f.size), fixed_dofs)
    u[free] = 0.0
    rhs = f - k @ u
    u[free] = spl.spsolve(k[free][:, free].tocsc(), rhs[free])
    return u


def float64_reference(doc: dict):
    """(u, reactions, f, fixed) of a 2D truss document with E = A = 1 in
    float64: f the loads with the thermal block's f_th, fixed the fixed
    DOFs with the prescribed ones, u from `float64_solution` with the
    prescribed values, reactions K u - f on the fixed DOFs (0 on the
    free)."""
    f = np.asarray(doc["loads"], float)
    fixed = np.asarray(doc["fixed_dofs"], int)
    prescribed = None
    if "thermal" in doc:
        th = doc["thermal"]
        f = f + float64_thermal_loads(doc["nodes"], doc["elements"],
                                      th["alpha"], th["delta_t"])
    if "prescribed_displacements" in doc:
        pd = doc["prescribed_displacements"]
        prescribed = np.zeros(f.size)
        prescribed[pd["dofs"]] = pd["values"]
        fixed = np.union1d(fixed, pd["dofs"])
    u = float64_solution(doc["nodes"], doc["elements"], f, fixed, prescribed)
    reactions = float64_stiffness(doc["nodes"], doc["elements"]) @ u - f
    reactions[np.setdiff1d(np.arange(f.size), fixed)] = 0.0
    return u, reactions, f, fixed


def pinn_grid_document(rows: int, cols: int, max_iterations: int = 500,
                       tolerance: float = 1e-6) -> dict:
    """The grid as a PINN identification document (method "gd").

    Three MLP fields (E, A, rho) at the widths of corpus examples 4 and 7
    (20, 15, 10), two hidden layers, input_dim 3 (load-factor-aware
    (lf, x, y) inputs: the fields kernel 4 takes); every free DOF measured,
    from a float64 solve with E = A = 1; alpha_data 100 and example 7's
    learning rates; one increment of max_iterations GD steps.  The edge
    loads sum to 1, so the displacements are of order 1 and lr_u = 0.01
    moves them within a few hundred steps.
    """
    nodes, elements, loads, fixed = grid_arrays(rows, cols)
    loads = loads / rows
    u = float64_solution(nodes, elements, loads, fixed)
    free = np.setdiff1d(np.arange(loads.size), fixed)

    def nn(width):
        return {"enabled": True, "hidden_layers": 2,
                "neurons_per_layer": width, "input_dim": 3}

    return {
        "description": f"PINN identification of E, A, rho on the cross-braced "
                       f"{rows}x{cols} grid strip",
        "nodes": nodes.tolist(),
        "elements": elements.tolist(),
        "fixed_dofs": fixed.tolist(),
        "loads": loads.tolist(),
        "material": {"young": 1.0, "area": 1.0, "density": 1.0},
        "nn_config": {"young": nn(20), "area": nn(15), "density": nn(10)},
        "measured_displacements": {"global_dof": free.tolist(),
                                   "measured_u": u[free].tolist()},
        "solver_type": "pinn-gd",
        "solver_config": {"n_increments": 1},
        "pinn_config": {"max_iterations": max_iterations,
                        "tolerance": tolerance, "learning_rate_u": 0.01,
                        "learning_rate_theta": 0.0005, "alpha_physics": 1.0,
                        "alpha_data": 100.0, "print_every": 100,
                        "preconditioning": False},
    }


def transient_grid_document(rows: int, cols: int, **analysis) -> dict:
    """The grid document (`grid_document`) with a transient "analysis"
    block: central difference at dt "auto", damping [0.05, 0], a unit
    step load, 200 steps recorded every 20, probing the right edge's
    bottom, middle and top nodes; `analysis` overrides any key."""
    doc = grid_document(rows, cols)
    nid = np.arange(rows * cols).reshape(rows, cols)
    doc["description"] += ", transient step load"
    doc["analysis"] = {
        "type": "transient", "method": "central", "dt": "auto",
        "n_steps": 200, "record_every": 20, "damping": [0.05, 0.0],
        "amplitude": {"type": "step"},
        "probe_nodes": [int(nid[0, -1]), int(nid[rows // 2, -1]),
                        int(nid[-1, -1])],
        **analysis}
    return doc


def float64_lumped_mass(nodes, elements) -> np.ndarray:
    """Lumped mass of a 2D truss with rho = A = 1: half of each element's
    length on every DOF of its two nodes."""
    nodes, el = np.asarray(nodes, float), np.asarray(elements)
    length = np.linalg.norm(nodes[el[:, 1]] - nodes[el[:, 0]], axis=1)
    m = np.zeros(2 * nodes.shape[0])
    np.add.at(m, _dofs_2d(el), np.repeat(0.5 * length[:, None], 4, 1))
    return m


def float64_transient(doc: dict, dt: float, n_steps=None) -> dict:
    """A 2D transient grid document (E = A = rho = 1, no prestress, no
    "load" spec) integrated in float64 at step dt: {"times",
    "displacements", "velocities"} at its probes, as the port records
    them (central: the consistent start and the centred peek velocity;
    newmark: the average-acceleration recurrence by default).  n_steps
    cuts the run (a multiple of record_every)."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spl

    from .io._common import _amplitude_array, _probe_dofs

    an = doc["analysis"]
    n_steps = int(an["n_steps"]) if n_steps is None else int(n_steps)
    every = int(an.get("record_every", 1))
    alpha, beta = (float(c) for c in an.get("damping", [0.0, 0.0]))
    amp = _amplitude_array(an.get("amplitude"), int(an["n_steps"]), dt)
    k = float64_stiffness(doc["nodes"], doc["elements"])
    f = np.asarray(doc["loads"], float)
    mask = np.ones(f.size)
    mask[np.asarray(doc["fixed_dofs"], int)] = 0.0
    m = float64_lumped_mass(doc["nodes"], doc["elements"]) * mask \
        + (1.0 - mask)
    probe = _probe_dofs(an, TrussProblem(
        np.asarray(doc["nodes"], float), np.asarray(doc["elements"]),
        Material(young=1.0, area=1.0, density=1.0), f, doc["fixed_dofs"]))

    def force(i):
        return amp[min(i, amp.size - 1)] * f

    def c_apply(v):
        return alpha * (m * v) + beta * (k @ v)

    us, vs = [], []
    u, v = np.zeros(f.size), np.zeros(f.size)
    if an.get("method", "central") == "central":
        def step(i, u, u_prev):
            v_lag = (u - u_prev) / dt
            return (2.0 * u - u_prev + dt * dt / m
                    * (force(i) - k @ u - c_apply(v_lag))) * mask

        u_prev = u - dt * v + 0.5 * dt * dt / m * (
            force(0) - k @ u - c_apply(v)) * mask
        for i in range(n_steps):
            u, u_prev = step(i, u, u_prev), u
            if (i + 1) % every == 0:
                peek = step(i + 1, u, u_prev)
                us.append(u[probe])
                vs.append(((peek - u_prev) / (2.0 * dt))[probe])
    else:
        nb = float(an.get("newmark_beta", 0.25))
        ng = float(an.get("newmark_gamma", 0.5))
        a0, a1, a2 = 1 / (nb * dt * dt), ng / (nb * dt), 1 / (nb * dt)
        a3, a4 = 1 / (2 * nb) - 1, ng / nb - 1
        a5, a6, a7 = 0.5 * dt * (ng / nb - 2), dt * (1 - ng), ng * dt
        free = np.flatnonzero(mask)
        k_eff = ((1 + a1 * beta) * k + sp.diags((a0 + a1 * alpha) * m)
                 ).tocsc()[free][:, free]
        lu = spl.splu(k_eff.tocsc())
        a = (force(0) - k @ u - c_apply(v)) * mask / m
        for i in range(n_steps):
            rhs = (force(i + 1) + m * (a0 * u + a2 * v + a3 * a)
                   + c_apply(a1 * u + a4 * v + a5 * a))
            u_new = np.zeros(f.size)
            u_new[free] = lu.solve(rhs[free])
            a_new = (a0 * (u_new - u) - a2 * v - a3 * a) * mask
            v = (v + a6 * a + a7 * a_new) * mask
            u, a = u_new, a_new
            if (i + 1) % every == 0:
                us.append(u[probe])
                vs.append(v[probe])
    return {"times": dt * every * np.arange(1, len(us) + 1),
            "displacements": np.asarray(us), "velocities": np.asarray(vs)}


def plane_strip_document(nx: int, ny: int, width: float = 1.0,
                         height: float = 4.0, traction: float = 10.0,
                         young: float = 1000.0, **analysis) -> dict:
    """The JAX package's banded plane benchmark strip as a document: an
    nx x ny Q4 plane-stress strip of width x height (E = young, nu 0.3,
    t 0.1), the left edge on x-rollers, the bottom on y-rollers, a uniform
    traction along x on the right edge (closed form u_x = traction x /
    young), static analysis at tolerance 1e-7 probing the top edge;
    `analysis` overrides any key of the analysis block."""
    return {
        "element_type": "plane",
        "description": f"{nx} x {ny} Q4 strip in uniaxial tension",
        "mesh": {"type": "rect", "width": width, "height": height,
                 "nx": nx, "ny": ny, "element": "quad"},
        "material": {"young": young, "poisson": 0.3, "thickness": 0.1,
                     "density": 1.0},
        "plane_strain": False,
        "fixed_x_nodes": "left",
        "fixed_y_nodes": "bottom",
        "edge_loads": [{"nodes": "right", "traction": [traction, 0.0]}],
        "analysis": {"type": "static", "tolerance": 1e-7,
                     "probe_nodes": "top", **analysis},
    }


# Load factors of dyn-plane-plastic.json: 0.5, 0.9, 0.95 and 0.99 of the
# limit pressure (2 / sqrt 3) sigma_y ln(b / a) with b / a = 2.
ANNULUS_LIMIT_FRACTIONS = (0.5, 0.9, 0.95, 0.99)


def plane_annulus_document(nr: int, nt: int, **analysis) -> dict:
    """The corpus thick-wall cylinder (dyn-plane-plastic.json) on an
    nr x nt quarter annulus: plane strain, E 1000, nu 0.3, inner radius 1,
    outer 2, unit pressure on the bore, y-rollers on the theta = 0 edge
    ("bottom") and x-rollers on the theta = 90 degree edge ("left"),
    perfectly plastic von Mises with sigma_y 1 ramped to 0.99 of the
    limit pressure, probing the bore and outer nodes of the theta = 0
    edge; `analysis` overrides any key of the analysis block."""
    p_lim = 2.0 / np.sqrt(3.0) * np.log(2.0)
    return {
        "element_type": "plane",
        "description": f"thick-wall cylinder, {nr} x {nt} quarter annulus",
        "mesh": {"type": "annulus", "r_inner": 1.0, "r_outer": 2.0,
                 "nr": nr, "nt": nt},
        "material": {"young": 1000.0, "poisson": 0.3, "thickness": 1.0,
                     "density": 1.0},
        "plane_strain": True,
        "edge_loads": [{"nodes": list(range(0, nt * (nr + 1) + 1, nr + 1)),
                        "pressure": 1.0}],
        "fixed_y_nodes": "bottom",
        "fixed_x_nodes": "left",
        "analysis": {"type": "plastic", "sigma_y": 1.0,
                     "load_factors": [float(p_lim * s) for s in
                                      ANNULUS_LIMIT_FRACTIONS],
                     "tolerance": 1e-8, "max_iterations": 40,
                     "probe_nodes": [0, nr], **analysis},
    }


def plane_sparse_matrices(problem, with_mass: bool = False):
    """(K, M) of a plane problem as float64 scipy CSR matrices from the
    port's element blocks (M None unless with_mass); point masses are not
    included."""
    import scipy.sparse as sp
    import torch

    from .models import plane as P

    coords, _ = P._elements(problem, "cpu")
    dm = problem.dof_map()
    rows = np.repeat(dm, dm.shape[1], axis=1).ravel()
    cols = np.tile(dm, (1, dm.shape[1])).ravel()
    n = problem.ndof

    def csr(blocks: "torch.Tensor"):
        return sp.csr_matrix((blocks.numpy().ravel(), (rows, cols)),
                             shape=(n, n))

    k = csr(P._stiffness_blocks(problem, "cpu"))
    if not with_mass:
        return k, None
    rho, thick = P._material(problem, "cpu", "density", "thickness")
    return k, csr(P._m_blocks(coords, rho, thick, problem.nen))
