#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its own line(s); any failed check raises, so the exit
code is not 0 and no result line is printed:

  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build of the CUDA kernels from pinn_fem_tpu_torch/ops/kernels/csrc;
  3. each kernel against its plain PyTorch twin on the card: the stencil
     on the 2,000,002-DOF chain and the 40,000-DOF grid (bit-equal), the
     two PCG kernels for one step, the fused PCG against its twin
     recurrence on the grid, and 300 PCG iterations at tol = 0 on the
     chain (ms per iteration for both);
  4. the main path: the 100 x 200 cross-braced grid document (40,000 DOFs,
     79,102 elements, tol 1e-5, 2 load increments) through
     pinn_fem_tpu_torch.cli.generic.main on cuda, checked against a
     float64 scipy solve, with every kernel's launch count from that run;
  5. corpus example1 on cuda (the dense path).

The line before the last is {"kernels": [...]}; the last is
{"ok": true, "device": {...}}.  Needs one card; imports no JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"
GRID = (100, 200)
GRID_TOL = 1e-5
CHAIN_NODES = 1_000_001
CG_ITERS = 300
SOURCE = "pinn_fem_tpu_torch/ops/kernels/csrc/dia_cg.cu"
REPLACES = {
    "dia_matvec": "pinn_fem_tpu/ops/pallas/dia_kernel.py:100",
    "dia_dir_matvec": "pinn_fem_tpu/ops/pallas/cg_kernel.py:97",
    "cg_update": "pinn_fem_tpu/ops/pallas/cg_kernel.py:115",
}


def log(phase: str, **fields) -> None:
    print(phase, json.dumps(fields), flush=True)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, reps: int) -> float:
    """Mean ms per call of fn over `reps` calls, by CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_card():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "?"
    print(card, flush=True)
    log("phase1_card", torch=torch.__version__, cuda=torch.version.cuda,
        python=sys.version.split()[0],
        cuda_available=torch.cuda.is_available())
    require(torch.cuda.is_available(), "torch.cuda.is_available()")
    return card


def phase_build():
    sys.path.insert(0, str(ROOT))
    from pinn_fem_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    _build.load_library()
    log("phase2_build", seconds=time.perf_counter() - t0,
        library=os.path.relpath(_build.library_path(), ROOT))


def banded_system(problem, dev):
    from pinn_fem_tpu_torch.ops.cg import stiffness_coefficients
    from pinn_fem_tpu_torch.ops.dia import assemble_dia, dia_layout

    data = problem.to_device(dev)
    layout = dia_layout(data.dof_map.cpu().numpy(), problem.ndof)
    diags = assemble_dia(layout,
                         stiffness_coefficients(data, problem.material, 1.0),
                         data.gvec)
    return data, layout, diags


def max_err(a, b) -> float:
    return float((a - b).abs().max())


def phase_kernels(dev):
    import torch

    from pinn_fem_tpu_torch.examples_grid import chain_problem, grid_problem
    from pinn_fem_tpu_torch.ops.dia import dia_cg_solve_reference
    from pinn_fem_tpu_torch.ops.kernels import cg_kernel, dia_kernel
    from pinn_fem_tpu_torch.ops.kernels import fused_cg_solve
    from pinn_fem_tpu_torch.ops.kernels import fused_cg_solve_reference

    gen = torch.Generator(device=dev).manual_seed(0)
    stats = {}
    systems = {"grid_40k": banded_system(grid_problem(*GRID), dev),
               "chain_2M": banded_system(chain_problem(CHAIN_NODES), dev)}
    for name, (data, layout, diags) in systems.items():
        n = layout.ndof
        u, z, p, x, r = (torch.randn(n, generator=gen, device=dev)
                         for _ in range(5))
        inv_diag = torch.rand(n, generator=gen, device=dev) + 0.1
        mask = data.free_mask

        # Kernel 1: bit-equal to its twin (same order, no FMA contraction).
        y = dia_kernel.dia_matvec(layout, diags, u)
        y_ref = dia_kernel.dia_matvec_reference(layout, diags, u)
        require(torch.equal(y, y_ref), f"dia_matvec bit-equal on {name}")
        k1 = dict(err=max_err(y, y_ref),
                  ms=cuda_ms(lambda: dia_kernel.dia_matvec(layout, diags, u), 200),
                  plain_ms=cuda_ms(lambda: dia_kernel.dia_matvec_reference(
                      layout, diags, u), 20))
        log("phase3_dia_matvec", mesh=name, ndof=n, n_diags=layout.n_diags,
            bit_equal=True, max_abs_err=k1["err"], ms=k1["ms"],
            plain_ms=k1["plain_ms"])

        # Kernel 2, one step.
        beta = torch.tensor(0.37, device=dev)
        got = cg_kernel.dia_dir_matvec(beta, z, p, layout, diags, mask)
        want = cg_kernel.dir_matvec_reference(beta, z, p, layout, diags, mask)
        err2 = max(max_err(a, b) / float(b.abs().max())
                   for a, b in zip(got, want))
        require(err2 <= 1e-6, f"dia_dir_matvec within 1e-6 on {name}")
        equal2 = all(torch.equal(a, b) for a, b in zip(got, want))
        k2 = dict(err=max(max_err(a, b) for a, b in zip(got, want)),
                  ms=cuda_ms(lambda: cg_kernel.dia_dir_matvec(
                      beta, z, p, layout, diags, mask), 200),
                  plain_ms=cuda_ms(lambda: cg_kernel.dir_matvec_reference(
                      beta, z, p, layout, diags, mask), 20))
        log("phase3_dia_dir_matvec", mesh=name, max_rel_err=err2,
            bit_equal=equal2, ms=k2["ms"], plain_ms=k2["plain_ms"])

        # Kernel 3, one step (in place: work on copies).
        alpha = torch.tensor(0.21, device=dev)
        xk, rk, zk = x.clone(), r.clone(), torch.empty_like(x)
        xr, rr, zr = x.clone(), r.clone(), torch.empty_like(x)
        pk = cg_kernel.cg_update(alpha, xk, rk, p, z, inv_diag, zk)
        pr = cg_kernel.cg_update_reference(alpha, xr, rr, p, z, inv_diag, zr)
        pairs = [(xk, xr), (rk, rr), (zk, zr), (pk, pr)]
        err3 = max(max_err(a, b) / float(b.abs().max()) for a, b in pairs)
        require(err3 <= 1e-6, f"cg_update within 1e-6 on {name}")
        equal3 = all(torch.equal(a, b) for a, b in pairs)
        # The timing loops update x, r and z in place again and again.
        k3 = dict(err=max(max_err(a, b) for a, b in pairs),
                  ms=cuda_ms(lambda: cg_kernel.cg_update(
                      alpha, xk, rk, p, z, inv_diag, zk), 200),
                  plain_ms=cuda_ms(lambda: cg_kernel.cg_update_reference(
                      alpha, xr, rr, p, z, inv_diag, zr), 20))
        log("phase3_cg_update", mesh=name, max_rel_err=err3,
            bit_equal=equal3, ms=k3["ms"], plain_ms=k3["plain_ms"])
        stats[name] = {"dia_matvec": k1, "dia_dir_matvec": k2,
                       "cg_update": k3}

    # Fused PCG on the grid, at the tolerances the Newton solve uses.
    data, layout, diags = systems["grid_40k"]
    cg_tol, cg_max = 0.1 * GRID_TOL, min(max(20 * layout.ndof, 1000), 100_000)
    runs = {}
    for label, solver in (("fused", fused_cg_solve),
                          ("twin", fused_cg_solve_reference),
                          ("plain", dia_cg_solve_reference)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, it, res = solver(layout, diags, data.loads, data.free_mask,
                            tol=cg_tol, max_iter=cg_max)
        torch.cuda.synchronize()
        runs[label] = (x, int(it), float(res), time.perf_counter() - t0)
    xf, itf, resf, tf = runs["fused"]
    xt, itt, _, tt = runs["twin"]
    require(itf == itt, "fused PCG iterations equal the twin recurrence's")
    x_err = max_err(xf, xt) / float(xt.abs().max())
    require(x_err <= 1e-5, "fused PCG x within 1e-5 max|x| of the twin")
    log("phase3_fused_cg_grid_40k", iterations=itf, twin_iterations=itt,
        plain_recurrence_iterations=runs["plain"][1], rel_residual=resf,
        x_rel_err=x_err, bit_equal=bool(torch.equal(xf, xt)),
        fused_s=tf, twin_s=tt, plain_s=runs["plain"][3])

    # 300 PCG iterations at tol = 0 on the chain (benchmarks/scaling.py
    # cg_iteration_fused / cg_iteration_xla): x of node 0 and every y
    # pinned, the free end pulled.
    data, layout, diags = systems["chain_2M"]
    mask = torch.ones(layout.ndof, device=dev)
    mask[0] = 0.0
    mask[1::2] = 0.0
    rhs = torch.zeros(layout.ndof, device=dev)
    rhs[-2] = 1.0
    ms = {}
    order = ["plain", "fused", "twin", "twin", "fused", "plain"]
    solvers = {"fused": fused_cg_solve, "twin": fused_cg_solve_reference,
               "plain": dia_cg_solve_reference}
    for label in order:
        t = cuda_ms(lambda: solvers[label](layout, diags, rhs, mask, tol=0.0,
                                           max_iter=CG_ITERS), 1)
        ms.setdefault(label, []).append(t / CG_ITERS)
    _, it300, _ = fused_cg_solve(layout, diags, rhs, mask, tol=0.0,
                                 max_iter=CG_ITERS)
    require(int(it300) == CG_ITERS, "300 iterations at tol = 0")
    log("phase3_cg_iteration_chain_2M", ndof=layout.ndof, iterations=CG_ITERS,
        fused_ms_per_iter=ms["fused"], twin_ms_per_iter=ms["twin"],
        plain_ms_per_iter=ms["plain"])
    del systems
    torch.cuda.empty_cache()
    return stats


def float64_check(doc, u):
    """Host float64 residual of u, and u's distance from a float64 solve."""
    import numpy as np
    import scipy.sparse as sp
    import scipy.sparse.linalg as spl

    nodes = np.asarray(doc["nodes"], float)
    el = np.asarray(doc["elements"])
    f = np.asarray(doc["loads"], float)
    dx = nodes[el[:, 1]] - nodes[el[:, 0]]
    length = np.linalg.norm(dx, axis=1)
    g = np.concatenate([-dx, dx], axis=1) / length[:, None]
    dof = np.concatenate([2 * el[:, :1], 2 * el[:, :1] + 1,
                          2 * el[:, 1:], 2 * el[:, 1:] + 1], axis=1)
    ke = g[:, :, None] * g[:, None, :] / length[:, None, None]  # E = A = 1
    k = sp.coo_matrix((ke.ravel(), (np.repeat(dof, 4, 1).ravel(),
                                    np.tile(dof, (1, 4)).ravel())),
                      shape=(f.size, f.size)).tocsr()
    free = np.setdiff1d(np.arange(f.size), doc["fixed_dofs"])
    residual = (np.linalg.norm((f - k @ u)[free])
                / np.linalg.norm(f[free]))
    u_ref = np.zeros(f.size)
    u_ref[free] = spl.spsolve(k[free][:, free].tocsc(), f[free])
    return residual, float(np.abs(u - u_ref).max() / np.abs(u_ref).max())


def phase_main_path(workdir: Path):
    import numpy as np

    from pinn_fem_tpu_torch.cli.generic import main
    from pinn_fem_tpu_torch.examples_grid import grid_document
    from pinn_fem_tpu_torch.ops import kernels

    doc = grid_document(*GRID, tolerance=GRID_TOL, n_increments=2)
    path = workdir / "grid100x200.json"
    path.write_text(json.dumps(doc))
    os.environ["PINN_FEM_TORCH_DEVICE"] = DEVICE

    # Cold: a fresh process (torch import, CUDA start, library load).
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pinn_fem_tpu_torch.cli.generic", str(path)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    cold_s = time.perf_counter() - t0
    require(proc.returncode == 0,
            f"cold CLI run exit code 0, got {proc.returncode}:\n"
            f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    rc = main([str(path)])
    first_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    require(rc == 0, "CLI exit code 0")
    out = json.loads((workdir / "grid100x200.res.json").read_text())
    require(out["converged"] is True, "converged")
    for name, n in launches.items():
        require(n > 0, f"{name} launched on the main path")

    t0 = time.perf_counter()
    require(main([str(path)]) == 0, "warm CLI run exit code 0")
    warm_s = time.perf_counter() - t0

    u = np.asarray(out["displacements"], float)
    require(bool(np.all(np.isfinite(u))) and u.size == 2 * GRID[0] * GRID[1],
            "finite displacements of the expected shape")
    residual, u_err = float64_check(doc, u)
    log("phase4_main_path", ndof=u.size, elements=len(doc["elements"]),
        converged=out["converged"], history=out["history"],
        float64_residual=residual, u_rel_err_vs_scipy=u_err,
        cold_process_s=cold_s, first_in_process_s=first_s, warm_s=warm_s,
        launches=launches)
    require(residual <= GRID_TOL ** 0.5, "float64 residual <= sqrt(tol)")
    require(u_err <= 1e-3, "max|u - u_scipy| / max|u_scipy| <= 1e-3")
    return launches


def phase_dense(workdir: Path):
    import numpy as np

    from pinn_fem_tpu_torch.cli.generic import main

    path = workdir / "example1.json"
    path.write_text((ROOT / "examples" / "json" / "example1.json").read_text())
    require(main([str(path)]) == 0, "example1 exit code 0")
    out = json.loads((workdir / "example1.res.json").read_text())
    err = float(np.abs(np.asarray(out["displacements"])
                       - [0, 0, 1, 0, 2, 0, 3, 0]).max())
    require(out["converged"] is True and err <= 2e-5,
            "example1 displacements within 2e-5")
    log("phase5_example1", converged=True, max_abs_err=err)


def main() -> int:
    card = phase_card()
    phase_build()
    import torch

    dev = torch.device(DEVICE)
    stats = phase_kernels(dev)
    with tempfile.TemporaryDirectory() as tmp:
        launches = phase_main_path(Path(tmp))
        phase_dense(Path(tmp))

    grid = stats["grid_40k"]
    entries = []
    for name in ("dia_matvec", "dia_dir_matvec", "cg_update"):
        entries.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": max(stats[m][name]["err"] for m in stats),
            "ms": grid[name]["ms"], "plain_ms": grid[name]["plain_ms"],
        })
    print(card, flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
