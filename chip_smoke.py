#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its own line(s); any failed check raises, so the exit
code is not 0 and no result line is printed:

  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build of the CUDA kernels from pinn_fem_tpu_torch/ops/kernels/csrc;
  3. each kernel against its plain PyTorch twin on the card: the stencil
     on the 2,000,002-DOF chain and the 40,000-DOF grid (staged window,
     bit-equal, and on a misaligned view of u), and on a 63-diagonal band
     too wide for shared memory (the kernel's unstaged path, bit-equal);
     the two PCG kernels for one step, both bit-equal to their twins (the
     direction kernel also on misaligned views and on the wide band's
     unstaged path, with its plan logged; the update with its device
     state); the fused PCG against its twin recurrence on the grid, and
     300 PCG iterations at tol = 0 on the chain (ms per iteration for
     both); a torch.profiler window of 64 fused PCG iterations on the grid
     and on the chain (device kernels per iteration, busy and idle share,
     device us per launch of each banded kernel), and the direction
     kernel's plan, ms, device us and share of its bound at both sizes;
  4. the Newton main path: the 100 x 200 cross-braced grid document
     (40,000 DOFs, 79,102 elements, tol 1e-5, 2 load increments) through
     pinn_fem_tpu_torch.cli.generic.main on cuda, checked against a
     float64 scipy solve, with the banded kernels' launch counts from that
     run;
  5. corpus example1 on cuda (the dense path);
  6. kernel 4, the material fields' forward and backward kernels, against
     their twin (the twin's autograd for the backward) at the grid's 79,102
     midpoints and on a 1,000,000-element chain, with 1 and 2 hidden
     layers and load factors 0.3 and 1.0; the forward also bit for bit
     against a second call, with its plan, registers and local bytes
     logged; the backward (4b) also against
     its plain version (material_coefficients_backward_reference), bit
     for bit against a second call, and with gs alone (the GD path: the
     density block exactly zero); ms of kernel, plain version, twin and
     torch form (each field's eval_batch and the product), the s-only
     call's ms beside its own bound, host us per wrapper call, and a
     profile: device us per launch of both kernels, one device kernel per
     call;
  7. the GD main path: the grid as a PINN document (three MLP fields,
     pinn_grid_document) through main() on cuda for GD_ITERS iterations,
     with both material kernels' launch counts from that run, ms per GD
     iteration, a profile of GD iterations, and the first CPU_ROWS history
     rows against a CPU run of the same document (the twin);
  8. corpus example2 (scalar GD) and example7-P (hybrid, three NN fields,
     initial weights as the JAX CLI draws them) on cuda.

Every kernel is held to its plain version by the tolerance stated where it
is checked.  The line before the last is {"kernels": [...]}, one entry per
kernel with its launches on its main path, error, ms (CUDA events), the
twin's ms, the bound (bytes at 3.35 TB/s or operations at 67 TFLOP/s FP32,
whichever is larger), a one-call PyTorch yardstick where one exists, the
device us per launch from the profiler, for the two PCG kernels the
wrapper's ms per call beside the ms of the launch bound once as the PCG
loop calls it, and for the material kernels the host us per wrapper call
(the backward also its twin's ms and the s-only call's ms and bound);
the last is {"ok": true, "device": {...}}.  Needs one card; imports no JAX.
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
# Newton iterations on the grid with the earlier update kernel (float32
# dot products summed outside it): 18 stencils.
EARLIER_NEWTON_ITERATIONS = 8
CHAIN_NODES = 1_000_001
WIDE_NDOF = 1_000_001
CG_ITERS = 300
MAT_CHAIN_ELEMENTS = 1_000_000
# 600: the loss falls below a fifth of its start only after about 530 GD
# steps from the initial weights the JAX CLI draws (the CPU twin: 0.230
# at 500, 0.147 at 600).
GD_ITERS = 600
CPU_ROWS = 50
# Card vs CPU twin, first CPU_ROWS GD history rows: max |difference| over
# each column's largest value.  Adam steps every component by about lr from
# its first step on, whatever the size of its gradient, so float32 noise in
# near-zero gradients moves the trajectory: two CPU runs of this document
# whose measured data differ by one float32 ulp drift 2.8e-2 apart
# (loss_physics) within 50 rows, u_norm 2.3e-3, theta_norm 2.3e-6
# (tests/measure_torch_agreement.py drift).  The first row precedes any
# step; it and theta_norm are held tightly.
GD_ROWS_RTOL = 0.1
GD_FIRST_ROW_RTOL = 1e-5
GD_THETA_RTOL = 1e-4
BYTES_PER_S = 3.35e12   # H100 SXM HBM3
FLOPS = 67e12           # H100 SXM FP32, outside the tensor cores
CSRC = "pinn_fem_tpu_torch/ops/kernels/csrc/"
KERNELS = {  # name: (source, TPU kernel it replaces)
    "dia_matvec": ("dia_cg.cu", "pinn_fem_tpu/ops/pallas/dia_kernel.py:100"),
    "dia_dir_matvec": ("dia_cg.cu",
                       "pinn_fem_tpu/ops/pallas/cg_kernel.py:97"),
    "cg_update": ("dia_cg.cu", "pinn_fem_tpu/ops/pallas/cg_kernel.py:115"),
    "material_coefficients": (
        "material.cu", "pinn_fem_tpu/ops/pallas/material_kernel.py:89"),
    "material_coefficients_backward": (
        "material.cu", "JAX autodiff of pinn_fem_tpu/ops/assembly.py:30 "
        "(material_values)"),
}
BANDED = ("dia_matvec", "dia_dir_matvec", "cg_update")
MATERIAL = ("material_coefficients", "material_coefficients_backward")


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


def misaligned(v):
    """A copy of v in a view that starts 4 bytes past a 16-byte
    boundary."""
    import torch

    buf = torch.empty(v.numel() + 1, dtype=v.dtype, device=v.device)
    buf[1:].copy_(v)
    return buf[1:]


def max_err(a, b) -> float:
    return float((a - b).abs().max())


def bound(n_bytes: float, n_ops: float) -> dict:
    """The least time for the work: bytes at the memory rate or operations
    at the FP32 rate, whichever is longer."""
    t_bytes, t_ops = n_bytes / BYTES_PER_S, n_ops / FLOPS
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def banded_bounds(layout, nb: int, update_blocks: int) -> dict:
    """Bounds of the three banded kernels: each input read once, each
    output written once; nd multiply-adds per row of the stencil.  nb: the
    direction kernel's blocks (its partials); update_blocks: the update's
    fixed grid."""
    nd, n = layout.n_diags, layout.ndof
    return {
        # diagonals and int32 offsets, u in; y out
        "dia_matvec": bound(4 * nd * n + 4 * nd + 4 * 2 * n, 2 * nd * n),
        # diagonals, int32 offsets, z, p, mask, beta in; p_new, ap and one
        # partial per block out
        "dia_dir_matvec": bound(4 * nd * n + 4 * nd + 4 * 5 * n + 4 * nb + 4,
                                (2 * nd + 5) * n),
        # x, r, p, ap, inv_diag and the direction partials (counted once)
        # in; x, r, z and two partials per block out; the 32-byte state in
        # and out.  Per row 2 for x, 2 for r, 1 for z, 4 for the two dots;
        # the sums of the partials besides.
        "cg_update": bound(4 * 8 * n + 4 * nb + 8 * update_blocks + 64,
                           9 * n + nb + 2 * update_blocks),
    }


def csr_of(layout, diags):
    """K of the banded layout as a torch CSR matrix (the library yardstick
    for the stencil)."""
    import torch

    n, dev = layout.ndof, diags.device
    rows = torch.arange(n, device=dev).repeat(layout.n_diags, 1)
    cols = rows + layout.offsets_on(dev)[:, None]
    keep = (cols >= 0) & (cols < n) & (diags != 0)
    coo = torch.sparse_coo_tensor(torch.stack([rows[keep], cols[keep]]),
                                  diags[keep], (n, n)).coalesce()
    return coo.to_sparse_csr()


def mlp_ops(widths, backward: bool) -> int:
    """Operations per element of the three nets (transcendentals counted
    as one), from csrc/material.cu.  widths: [(h1, h2), ...], h2 = 0 with
    one hidden layer."""
    total = 0
    for h1, h2 in widths:
        last = h2 or h1
        fwd = 2 * 3 * h1 + 2 * h1 + (2 * h1 * h2 + 2 * h2) + 2 * last + 7
        total += fwd
        if backward:
            n_params = 4 * h1 + (h1 * h2 + h2) + last + 1
            # logistic and d_out, the deltas, and one multiply-add per
            # parameter term
            total += 6 + 4 * last + (2 * h1 * h2 + 3 * h1 if h2 else 0) \
                + 2 * n_params
    return total + (2 if not backward else 4)


def wide_band_layout(ndof: int):
    """63 diagonals at offsets 0, +-1290 j (j = 1..31): a band of 39,990
    rows, whose window no block's shared memory holds (the stencil
    kernel's unstaged path)."""
    import numpy as np

    from pinn_fem_tpu_torch.ops.dia import DiaLayout

    offs = np.array([1290 * j for j in range(-31, 32)], np.int64)
    return DiaLayout(offsets=offs, entry_slot=np.zeros((0, 2, 2), np.int64),
                     ndof=ndof, bandwidth=int(offs.max()))


def device_events(prof):
    """The profiler's device-side events (kernels and copies)."""
    import torch

    return [e for e in prof.events()
            if getattr(e, "device_type", None)
            == torch.autograd.DeviceType.CUDA
            and getattr(e, "device_time_total", 0) > 0]


def profiled(fn):
    """(host wall s, device events) of fn() under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return wall, device_events(prof)


KERNEL_SYMBOLS = {"dia_matvec": "stencil_kernel",
                  "dia_dir_matvec": "dia_dir_matvec_kernel",
                  "cg_update": "cg_update_kernel"}


def launched(name: str, symbol: str) -> bool:
    """Whether a profiler event's name is the kernel `symbol` (a
    template's name goes on with its arguments, "<...>")."""
    return symbol + "(" in name or symbol + "<" in name


def per_launch_us(events, name: str):
    """(launches, mean device us per launch) of one banded kernel."""
    symbol = KERNEL_SYMBOLS[name]
    mine = [e.device_time_total for e in events if launched(e.name, symbol)]
    return len(mine), (sum(mine) / len(mine) if mine else None)


def pcg_profile(layout, diags, rhs, mask, iters: int = 64) -> dict:
    """torch.profiler over `iters` fused PCG iterations at tol = 0 (setup
    included) and over the same call's setup alone (max_iter = 0): device
    kernels per iteration, other device operations the loop adds, busy and
    idle share of the window; on the device's timeline, from the first PCG
    kernel's start to the last one's end, ms per iteration and the idle
    share of the loop; and a window of `iters` stencil calls."""
    from pinn_fem_tpu_torch.ops.kernels import dia_matvec, fused_cg_solve

    def solve(n):
        return lambda: fused_cg_solve(layout, diags, rhs, mask, tol=0.0,
                                      max_iter=n)

    solve(iters)()                                    # warm-up
    wall0, ev0 = profiled(solve(0))
    for _ in range(3):  # a window may come back without some records
        wall, ev = profiled(solve(iters))
        n_dir, us_dir = per_launch_us(ev, "dia_dir_matvec")
        n_upd, us_upd = per_launch_us(ev, "cg_update")
        if n_dir + n_upd >= 2 * iters:
            break
    other = len(ev) - n_dir - n_upd - len(ev0)
    busy_ms = sum(e.device_time_total for e in ev) / 1e3
    pcg = [e for e in ev if any(KERNEL_SYMBOLS[k] + c in e.name
                                for k in ("dia_dir_matvec", "cg_update")
                                for c in "(<")]
    loop = {}
    if pcg:
        t0 = min(e.time_range.start for e in pcg)
        t1 = max(e.time_range.end for e in pcg)
        busy_us = sum(max(0.0, min(e.time_range.end, t1)
                          - max(e.time_range.start, t0)) for e in ev)
        loop = {"loop_span_ms": (t1 - t0) / 1e3,
                "loop_ms_per_iteration": (t1 - t0) / 1e3 / iters,
                "loop_device_busy_ms": busy_us / 1e3,
                "loop_device_idle_share": 1 - busy_us / (t1 - t0)}
    u = rhs.clone()
    _, ev_mv = profiled(lambda: [dia_matvec(layout, diags, u)
                                 for _ in range(iters)])
    n_mv, us_mv = per_launch_us(ev_mv, "dia_matvec")
    return {"iterations": iters, "wall_ms": 1e3 * wall,
            "setup_wall_ms": 1e3 * wall0,
            "pcg_kernels_per_iteration": (n_dir + n_upd) / iters,
            "other_device_ops_added_by_loop": other,
            "device_busy_ms": busy_ms,
            "device_idle_share": 1 - busy_ms / (1e3 * wall), **loop,
            "device_us": {"dia_matvec": us_mv, "dia_dir_matvec": us_dir,
                          "cg_update": us_upd},
            "launches_in_window": {"dia_matvec": n_mv,
                                   "dia_dir_matvec": n_dir,
                                   "cg_update": n_upd}}


def check_update(layout, dev, gen, pap, name):
    """Kernel 3, one step, against its twin (x, r, z, partials and the
    state, bit for bit); ms of kernel and twin."""
    import torch

    from pinn_fem_tpu_torch.ops.kernels import cg_kernel

    n = layout.ndof
    x, r, p, ap = (torch.randn(n, generator=gen, device=dev) for _ in range(4))
    inv_diag = torch.rand(n, generator=gen, device=dev) + 0.1
    state = cg_kernel.new_state(torch.dot(r, inv_diag * r), torch.dot(r, r),
                                torch.zeros((), device=dev), 2**31 - 1)
    outs = []
    for fn in (cg_kernel.cg_update, cg_kernel.cg_update_reference):
        xs, rs, st = x.clone(), r.clone(), state.clone()
        zs = torch.empty_like(x)
        parts = fn(pap, xs, rs, p, ap, inv_diag, zs, st, 2**31 - 1)
        outs.append((xs, rs, zs, parts, st))
    pairs = list(zip(*outs))
    err = max(max_err(a, b) / max(float(b.abs().max()), 1e-30)
              for a, b in pairs[:4])
    require(err <= 1e-6, f"cg_update within 1e-6 on {name}")
    equal = all(torch.equal(a, b) for a, b in pairs)
    require(equal, f"cg_update bit-equal to its twin, state included, on "
            f"{name}")
    require(int(cg_kernel.state_views(outs[0][4])[1][0]) == 1,
            "the update's epilogue counted the iteration")
    # Timing: with ap = 0 the update leaves r, rz and rn2 as they are, so
    # every timed call is live and does the same work.
    # ms: the launch bound once, as the PCG loop calls it; wrapper_ms: the
    # wrapper, which checks its operands on every call.
    zero = torch.zeros_like(ap)
    xs, rs, zs, st = x.clone(), r.clone(), torch.empty_like(x), state.clone()
    launch, _ = cg_kernel.bind_cg_update(pap, xs, rs, p, zero, inv_diag, zs,
                                         st, 2**31 - 1)
    return dict(err=max(max_err(a, b) for a, b in pairs[:4]), bit_equal=equal,
                ms=cuda_ms(launch, 200),
                wrapper_ms=cuda_ms(lambda: cg_kernel.cg_update(
                    pap, xs, rs, p, zero, inv_diag, zs, st, 2**31 - 1), 200),
                plain_ms=cuda_ms(lambda: cg_kernel.cg_update_reference(
                    pap, xs, rs, p, zero, inv_diag, zs, st, 2**31 - 1), 20))


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
        u, z, p = (torch.randn(n, generator=gen, device=dev) for _ in range(3))
        mask = data.free_mask

        # Kernel 1: bit-equal to its twin (same order, no FMA contraction),
        # also on a view of u that starts 4 bytes past a 16-byte boundary.
        plan = dia_kernel.stencil_plan(layout)
        y = dia_kernel.dia_matvec(layout, diags, u)
        y_ref = dia_kernel.dia_matvec_reference(layout, diags, u)
        require(torch.equal(y, y_ref), f"dia_matvec bit-equal on {name}")
        u_off = torch.randn(n + 1, generator=gen, device=dev)[1:]
        require(torch.equal(dia_kernel.dia_matvec(layout, diags, u_off),
                            dia_kernel.dia_matvec_reference(layout, diags,
                                                            u_off)),
                f"dia_matvec bit-equal on a misaligned view on {name}")
        k1 = dict(err=max_err(y, y_ref),
                  ms=cuda_ms(lambda: dia_kernel.dia_matvec(layout, diags, u), 200),
                  plain_ms=cuda_ms(lambda: dia_kernel.dia_matvec_reference(
                      layout, diags, u), 20))
        log("phase3_dia_matvec", mesh=name, ndof=n, n_diags=layout.n_diags,
            bandwidth=layout.bandwidth, plan=dict(
                threads=plan.threads, tile=plan.tile, blocks=plan.blocks,
                staged=plan.staged, shared_bytes=plan.shared_bytes),
            bit_equal=True, misaligned_bit_equal=True,
            max_abs_err=k1["err"], ms=k1["ms"], plain_ms=k1["plain_ms"])

        # Kernel 2, one step: bit-equal to its twin (p_new, ap and the
        # block partials), also on views of z, p and mask that start 4
        # bytes past a 16-byte boundary.
        beta = torch.tensor(0.37, device=dev)
        got = cg_kernel.dia_dir_matvec(beta, z, p, layout, diags, mask)
        want = cg_kernel.dir_matvec_reference(beta, z, p, layout, diags, mask)
        err2 = max(max_err(a, b) / float(b.abs().max())
                   for a, b in zip(got, want))
        require(err2 <= 1e-6, f"dia_dir_matvec within 1e-6 on {name}")
        equal2 = all(torch.equal(a, b) for a, b in zip(got, want))
        require(equal2, f"dia_dir_matvec bit-equal to its twin on {name}")
        zo, po, mo = (misaligned(t) for t in (z, p, mask))
        require(all(torch.equal(a, b) for a, b in zip(
            cg_kernel.dia_dir_matvec(beta, zo, po, layout, diags, mo),
            cg_kernel.dir_matvec_reference(beta, zo, po, layout, diags, mo))),
            f"dia_dir_matvec bit-equal on misaligned views on {name}")
        # ms: the launch bound once, as the PCG loop calls it; wrapper_ms:
        # the wrapper, which checks its operands on every call.
        out = tuple(torch.empty_like(t) for t in got)
        launch, _ = cg_kernel.bind_dir_matvec(beta, z, p, layout, diags, mask,
                                              out=out)
        k2 = dict(err=max(max_err(a, b) for a, b in zip(got, want)),
                  ms=cuda_ms(launch, 200),
                  wrapper_ms=cuda_ms(lambda: cg_kernel.dia_dir_matvec(
                      beta, z, p, layout, diags, mask, out=out), 200),
                  plain_ms=cuda_ms(lambda: cg_kernel.dir_matvec_reference(
                      beta, z, p, layout, diags, mask), 20))
        log("phase3_dia_dir_matvec", mesh=name, max_rel_err=err2,
            bit_equal=equal2, misaligned_bit_equal=True, ms=k2["ms"],
            wrapper_ms=k2["wrapper_ms"], plain_ms=k2["plain_ms"])

        # Kernel 3, one step, on kernel 2's partials.
        k3 = check_update(layout, dev, gen, got[2], name)
        log("phase3_cg_update", mesh=name, bit_equal=k3["bit_equal"],
            max_abs_err=k3["err"], ms=k3["ms"], wrapper_ms=k3["wrapper_ms"],
            plain_ms=k3["plain_ms"],
            update_blocks=cg_kernel.UPDATE_BLOCKS,
            direction_partials=got[2].numel())
        bounds = banded_bounds(layout, got[2].numel(), cg_kernel.UPDATE_BLOCKS)
        k1.update(bounds["dia_matvec"])
        k2.update(bounds["dia_dir_matvec"], library_ms=None)
        k3.update(bounds["cg_update"], library_ms=None)
        k_csr = csr_of(layout, diags)
        y_csr = k_csr @ u
        require(max_err(y_csr, y) <= 1e-5 * float(y.abs().max()),
                f"CSR yardstick computes the same K u on {name}")
        k1["library_ms"] = cuda_ms(lambda: k_csr @ u, 200)
        del k_csr
        log("phase3_bounds", mesh=name, **{
            k: {"bound_ms": v["bound_ms"], "bound_by": v["bound_by"]}
            for k, v in bounds.items()}, dia_matvec_csr_ms=k1["library_ms"])
        stats[name] = {"dia_matvec": k1, "dia_dir_matvec": k2,
                       "cg_update": k3}

    # Kernel 1's unstaged path: a band too wide for shared memory, with
    # ndof = 1 (mod 4), so diagonal rows of every alignment occur.
    wide = wide_band_layout(WIDE_NDOF)
    plan = dia_kernel.stencil_plan(wide)
    require(not plan.staged, "the wide band takes the unstaged path")
    d_wide = torch.randn(wide.n_diags, wide.ndof, generator=gen, device=dev)
    u_wide = torch.randn(wide.ndof + 1, generator=gen, device=dev)
    for uu in (u_wide[:-1], u_wide[1:]):
        y = dia_kernel.dia_matvec(wide, d_wide, uu)
        require(torch.equal(y, dia_kernel.dia_matvec_reference(wide, d_wide,
                                                               uu)),
                "dia_matvec bit-equal on the wide band")
    uu = u_wide[:-1]
    wide_ms = cuda_ms(lambda: dia_kernel.dia_matvec(wide, d_wide, uu), 50)
    log("phase3_dia_matvec_wide_band", ndof=wide.ndof, n_diags=wide.n_diags,
        bandwidth=wide.bandwidth, staged=plan.staged, bit_equal=True,
        misaligned_bit_equal=True, ms=wide_ms,
        plain_ms=cuda_ms(lambda: dia_kernel.dia_matvec_reference(
            wide, d_wide, uu), 5),
        bound_ms=banded_bounds(wide, 1, 1)["dia_matvec"]["bound_ms"])
    # Kernel 2's unstaged path on the same band: p_new rebuilt from z and p
    # at every neighbour, bit-equal, also on misaligned views.
    dplan = dia_kernel.direction_plan(wide)
    require(not dplan.staged, "kernel 2 takes the unstaged path on the "
            "wide band")
    zw, pw, mw = (torch.randn(wide.ndof, generator=gen, device=dev)
                  for _ in range(3))
    beta = torch.tensor(-0.37, device=dev)
    for args in ((zw, pw, mw), tuple(misaligned(t) for t in (zw, pw, mw))):
        got = cg_kernel.dia_dir_matvec(beta, args[0], args[1], wide, d_wide,
                                       args[2])
        want = cg_kernel.dir_matvec_reference(beta, args[0], args[1], wide,
                                              d_wide, args[2])
        require(all(torch.equal(a, b) for a, b in zip(got, want)),
                "dia_dir_matvec bit-equal on the wide band")
    log("phase3_dia_dir_matvec_wide_band", rows=dplan.rows,
        threads=dplan.threads, blocks=dplan.blocks, staged=dplan.staged,
        bit_equal=True, misaligned_bit_equal=True,
        ms=cuda_ms(lambda: cg_kernel.dia_dir_matvec(
            beta, zw, pw, wide, d_wide, mw, out=got), 50),
        bound_ms=banded_bounds(wide, dplan.blocks,
                               1)["dia_dir_matvec"]["bound_ms"])
    del d_wide, u_wide, uu, zw, pw, mw, got, want
    stats["wide_band"] = {"dia_matvec": {"err": 0.0},
                          "dia_dir_matvec": {"err": 0.0}}

    # Fused PCG on the grid, at the tolerances the Newton solve uses.
    data, layout, diags = systems["grid_40k"]
    cg_tol, cg_max = 0.1 * GRID_TOL, min(max(20 * layout.ndof, 1000), 100_000)
    runs = {}
    for label, solver in (("fused", fused_cg_solve),
                          ("twin", fused_cg_solve_reference),
                          ("plain", dia_cg_solve_reference)):
        solver(layout, diags, data.loads, data.free_mask, tol=cg_tol,
               max_iter=3)  # warm: the first call loads torch's kernels
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, it, res = solver(layout, diags, data.loads, data.free_mask,
                            tol=cg_tol, max_iter=cg_max)
        torch.cuda.synchronize()
        runs[label] = (x, int(it), float(res), time.perf_counter() - t0)
    xf, itf, resf, tf = runs["fused"]
    setup_s = []
    for _ in range(3):  # the same call's setup alone, warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fused_cg_solve(layout, diags, data.loads, data.free_mask, tol=cg_tol,
                       max_iter=0)
        torch.cuda.synchronize()
        setup_s.append(time.perf_counter() - t0)
    setup_s = sorted(setup_s)[1]
    xt, itt, _, tt = runs["twin"]
    require(itf == itt, "fused PCG iterations equal the twin recurrence's")
    require(bool(torch.equal(xf, xt)), "fused PCG x bit-equal to the twin's")
    x_err = max_err(xf, xt) / float(xt.abs().max())
    prof_grid = pcg_profile(layout, diags, data.loads, data.free_mask)
    log("phase3_fused_cg_grid_40k", iterations=itf, twin_iterations=itt,
        plain_recurrence_iterations=runs["plain"][1], rel_residual=resf,
        x_rel_err=x_err, bit_equal=True, fused_s=tf,
        fused_ms_per_iter=1e3 * tf / max(itf, 1), fused_setup_s=setup_s,
        fused_loop_ms_per_iter=1e3 * (tf - setup_s) / max(itf, 1), twin_s=tt,
        plain_s=runs["plain"][3], profile=prof_grid)
    require(prof_grid["pcg_kernels_per_iteration"] == 2.0,
            "two device kernels per fused PCG iteration")
    require(prof_grid["other_device_ops_added_by_loop"]
            <= 64 // cg_kernel.CHECK_EVERY,
            "no device work in the loop besides the two kernels and the "
            "flag copies")

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
    x300, it300, _ = fused_cg_solve(layout, diags, rhs, mask, tol=0.0,
                                    max_iter=CG_ITERS)
    require(int(it300) == CG_ITERS, "300 iterations at tol = 0")
    xt300, itt300, _ = fused_cg_solve_reference(layout, diags, rhs, mask,
                                                tol=0.0, max_iter=CG_ITERS)
    require(int(itt300) == CG_ITERS and bool(torch.equal(x300, xt300)),
            "300 fused iterations bit-equal to the twin recurrence")
    prof_chain = pcg_profile(layout, diags, rhs, mask)
    log("phase3_cg_iteration_chain_2M", ndof=layout.ndof, iterations=CG_ITERS,
        bit_equal=True, fused_ms_per_iter=ms["fused"],
        twin_ms_per_iter=ms["twin"], plain_ms_per_iter=ms["plain"],
        profile=prof_chain)
    require(prof_chain["pcg_kernels_per_iteration"] == 2.0,
            "two device kernels per fused PCG iteration on the chain")
    for name in BANDED:
        stats["grid_40k"][name]["device_us"] = prof_grid["device_us"][name]
    # Kernel 2 at both sizes: its plan, ms of the bound launch, device us
    # per launch in the PCG window and the share of its bound.
    for mesh, prof in (("grid_40k", prof_grid), ("chain_2M", prof_chain)):
        k2 = stats[mesh]["dia_dir_matvec"]
        dplan = dia_kernel.direction_plan(systems[mesh][1])
        us = prof["device_us"]["dia_dir_matvec"]
        log("phase3_dia_dir_matvec_summary", mesh=mesh, rows=dplan.rows,
            threads=dplan.threads, tile=dplan.tile, blocks=dplan.blocks,
            staged=dplan.staged, shared_bytes=dplan.shared_bytes,
            warps_per_sm=dplan.blocks * dplan.threads / 32 / dia_kernel.SMS,
            ms=k2["ms"], device_us=us,
            bound_ms=k2["bound_ms"],
            share_of_bound=1e3 * k2["bound_ms"] / us if us else None)
    del systems
    torch.cuda.empty_cache()
    return stats


def float64_check(doc, u):
    """Host float64 residual of u, and u's distance from a float64 solve."""
    import numpy as np

    from pinn_fem_tpu_torch.examples_grid import (float64_solution,
                                                  float64_stiffness)

    f = np.asarray(doc["loads"], float)
    k = float64_stiffness(doc["nodes"], doc["elements"])  # E = A = 1
    free = np.setdiff1d(np.arange(f.size), doc["fixed_dofs"])
    residual = (np.linalg.norm((f - k @ u)[free])
                / np.linalg.norm(f[free]))
    u_ref = float64_solution(doc["nodes"], doc["elements"], f,
                             doc["fixed_dofs"])
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
    for name in BANDED:
        require(launches[name] > 0, f"{name} launched on the main path")
    require(launches["dia_dir_matvec"] == launches["cg_update"],
            "one update per direction pass: two launches a PCG iteration")
    # Two stencils per Newton iteration and one per increment.  The count
    # is reported beside earlier runs', not gated: at tol 1e-5 Newton stops
    # at the float32 stall floor, where the step that fails to lower the
    # residual rides on the last bits of each PCG solution (ROADMAP fault
    # 3.5; PERF.md).
    newton_iterations = (launches["dia_matvec"] - 2) // 2

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
        launches=launches, newton_iterations=newton_iterations,
        earlier_newton_iterations=EARLIER_NEWTON_ITERATIONS)
    require(residual <= GRID_TOL ** 0.5, "float64 residual <= sqrt(tol)")
    require(u_err <= 1e-3, "max|u - u_scipy| / max|u_scipy| <= 1e-3")
    return {k: launches[k] for k in BANDED}


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


def mlp_material(hidden_layers: int, dev):
    """Three MLP fields at the PINN grid's widths (20, 15, 10), input_dim 3,
    seeded torch draws; the last layer is perturbed away from its constant
    start so that every parameter's gradient is exercised."""
    import torch

    from pinn_fem_tpu_torch import Material, make_mlp_field

    g = torch.Generator().manual_seed(hidden_layers)
    fields = []
    for width, scale in ((20, 2.0), (15, 0.5), (10, 7.0)):
        f = make_mlp_field(g, hidden_layers=hidden_layers,
                           neurons_per_layer=width, input_dim=3, scale=scale)
        w, b = f.layers[-1]
        f.layers[-1] = (w + 0.3 * torch.randn(w.shape, generator=g), b)
        fields.append(f)
    return Material(*fields).to(dev)


def phase_material(dev):
    """Kernel 4 forward and backward against the twin; ms of kernel, twin
    and torch form; the bounds at the grid's shapes."""
    import torch

    from pinn_fem_tpu_torch.examples_grid import chain_problem, grid_problem
    from pinn_fem_tpu_torch.ops.kernels import material_kernel as mk
    from pinn_fem_tpu_torch.solvers.gd import get_theta

    meshes = {"grid_79k": grid_problem(*GRID).to_device(dev),
              "chain_1M": chain_problem(MAT_CHAIN_ELEMENTS + 1).to_device(dev)}
    stats = {name: {"err": 0.0} for name in MATERIAL}
    for mesh, data in meshes.items():
        n = data.nelm
        c = torch.randn(4, n, device=dev,
                        generator=torch.Generator(dev).manual_seed(5))
        for hidden in (1, 2):
            mat = mlp_material(hidden, dev)
            params = torch.cat([t.reshape(-1)
                                for f in mk._fields(mat)
                                for t in f.trainable_params()])
            widths = mk._widths(mat)
            scales = torch.stack([f.scale for f in mk._fields(mat)])
            theta = [t for layers in get_theta(mat) for layer in layers
                     for t in layer]
            for lf in (0.3, 1.0):
                got = mk.material_coefficients(data.mid, data.inv_len, lf,
                                               params, scales, widths)
                require(all(torch.equal(a, b) for a, b in zip(
                    got, mk.material_coefficients(data.mid, data.inv_len, lf,
                                                  params, scales, widths))),
                        f"material forward bit for bit across two calls on "
                        f"{mesh}")
                with torch.enable_grad():
                    for t in theta:
                        t.requires_grad_(True)
                    want = mk.material_coefficients_reference(
                        data.mid, data.inv_len, lf, mat)
                    g_want = torch.cat([g.reshape(-1) for g in
                                        torch.autograd.grad(
                                            sum(torch.sum(ci * o) for ci, o
                                                in zip(c, want)), theta)])
                    for t in theta:
                        t.requires_grad_(False)
                want = [w.detach() for w in want]
                g_got = mk.material_coefficients_backward(
                    data.mid, data.inv_len, lf, params, scales, widths,
                    got[0], got[1], tuple(c))
                plain_rel = check_backward(mk, data, lf, params, scales,
                                           widths, got, tuple(c), g_got, mesh)
                s_only = (None, None, None, c[3])
                gs_got = mk.material_coefficients_backward(
                    data.mid, data.inv_len, lf, params, scales, widths,
                    got[0], got[1], s_only)
                s_rel = check_backward(mk, data, lf, params, scales, widths,
                                       got, s_only, gs_got, mesh)
                require(bool((gs_got[-mat.density.n_params():] == 0).all()),
                        f"s-only backward leaves the density block zero on "
                        f"{mesh}")
                rel = []
                for k, (a, b) in enumerate(zip(got, want)):
                    rtol = 3e-5 if k == 3 else 2e-5
                    require(bool(((a - b).abs() <= 1e-6 + rtol * b.abs()).all()),
                            f"material forward output {k} within rtol {rtol}"
                            f" / atol 1e-6 on {mesh}")
                    rel.append(max_err(a, b) / float(b.abs().max()))
                g_rel = max_err(g_got, g_want) / float(g_want.abs().max())
                require(g_rel <= 1e-4, "material backward within 1e-4 of "
                        f"max|grad| on {mesh}")
                stats["material_coefficients"]["err"] = max(
                    stats["material_coefficients"]["err"],
                    max(max_err(a, b) for a, b in zip(got, want)))
                stats["material_coefficients_backward"]["err"] = max(
                    stats["material_coefficients_backward"]["err"],
                    max_err(g_got, g_want))
                timing = {}
                if lf == 1.0:
                    timing = material_times(data, mat, lf, params, scales,
                                            widths, theta, c, got, reps=20)
                plan, occupancy = mk._forward_plan(data.mid.device, widths, n)
                log("phase6_material", mesh=mesh, elements=n,
                    hidden_layers=hidden, load_factor=lf,
                    forward_plan=plan._asdict(),
                    forward_blocks_per_sm=occupancy[0],
                    forward_registers=occupancy[2],
                    forward_local_bytes=occupancy[3],
                    forward_bit_equal_repeat=True,
                    max_rel_err_E_A_rho_s=rel, grad_max_rel_err=g_rel,
                    grad_max_rel_err_vs_plain=plain_rel,
                    s_only_grad_max_rel_err_vs_plain=s_rel,
                    backward_bit_equal_repeat=True, **timing)
                if hidden == 2 and lf == 1.0 and mesh == "grid_79k":
                    fw = [(h, h) for h in (20, 15, 10)]
                    io = 4 * (2 * n + n + 4 * n) + 4 * params.numel() + 12
                    stats["material_coefficients"].update(
                        ms=timing["kernel_ms"], plain_ms=timing["twin_ms"],
                        library_ms=None,
                        **bound(io, n * mlp_ops(fw, backward=False)))
                    stats["material_coefficients"].update(
                        device_us=timing["kernel_device_us"],
                        host_us=timing["kernel_host_us"])
                    # mid, 1/L, E, A and four upstream gradients in
                    io_b = 4 * (2 * n + 3 * n + 4 * n) + 8 * params.numel() + 12
                    # s alone: the young and area nets only; gs in, and
                    # the whole gradient out
                    io_s = (4 * (2 * n + 3 * n + n) + 4 * params.numel()
                            + 4 * (params.numel() - mat.density.n_params())
                            + 12)
                    s_bound = bound(io_s, n * mlp_ops(fw[:2], backward=True))
                    stats["material_coefficients_backward"].update(
                        ms=timing["kernel_backward_ms"],
                        plain_ms=timing["plain_backward_ms"],
                        twin_ms=timing["twin_backward_ms"], library_ms=None,
                        device_us=timing["kernel_backward_device_us"],
                        host_us=timing["kernel_backward_host_us"],
                        s_only_ms=timing["kernel_backward_s_only_ms"],
                        s_only_device_us=timing[
                            "kernel_backward_s_only_device_us"],
                        s_only_bound_ms=s_bound["bound_ms"],
                        **bound(io_b, n * mlp_ops(fw, backward=True)))
                    log("phase6_material_bounds", mesh=mesh,
                        forward=stats["material_coefficients"]["bound_ms"],
                        backward=stats["material_coefficients_backward"][
                            "bound_ms"], backward_s_only=s_bound["bound_ms"])
    del meshes
    torch.cuda.empty_cache()
    return stats


def check_backward(mk, data, lf, params, scales, widths, got, grads, g_got,
                   mesh) -> float:
    """Kernel 4b against its plain version (1e-5 of max|grad|) and against
    a second call (bit for bit); the relative error."""
    import torch

    g_plain = mk.material_coefficients_backward_reference(
        data.mid, data.inv_len, lf, params, scales, widths, got[0], got[1],
        grads)
    rel = max_err(g_got, g_plain) / float(g_plain.abs().max())
    require(rel <= 1e-5, "material backward within 1e-5 of max|grad| of its "
            f"plain version on {mesh}")
    require(bool(torch.equal(g_got, mk.material_coefficients_backward(
        data.mid, data.inv_len, lf, params, scales, widths, got[0], got[1],
        grads))), f"material backward bit for bit across two calls on {mesh}")
    return rel


def recorded_window(fn, tries: int = 3, enough=bool):
    """(device events, windows taken) of fn() under torch.profiler: the
    first of up to `tries` windows whose events satisfy `enough` (by
    default: any device event; on the card a window now and then comes
    back with none, or without many of its records)."""
    for window in range(1, tries + 1):
        _, ev = profiled(fn)
        if enough(ev):
            break
    return ev, window


def host_us(fn, reps: int = 200) -> float:
    """Host us per call of fn (time.perf_counter around `reps` calls after
    a synchronize; the calls only enqueue)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / reps


def material_times(data, mat, lf, params, scales, widths, theta, c, got,
                   reps):
    """ms of the forward and backward kernels, of the twin and of the
    torch form (each field's eval_batch on the assembly inputs, and the
    product), forward alone and backward alone."""
    import torch

    from pinn_fem_tpu_torch.models.fields import assembly_inputs
    from pinn_fem_tpu_torch.ops.kernels import material_kernel as mk

    def torch_form():
        x = assembly_inputs(data.mid, data.dimension, lf)
        e, a = mat.young.eval_batch(x), mat.area.eval_batch(x)
        return e, a, mat.density.eval_batch(x), e * a * data.inv_len

    def forward():
        return mk.material_coefficients(data.mid, data.inv_len, lf, params,
                                        scales, widths)

    def backward(grads=tuple(c)):
        return mk.material_coefficients_backward(
            data.mid, data.inv_len, lf, params, scales, widths, got[0],
            got[1], grads)

    s_only = (None, None, None, c[3])
    out = {
        "kernel_ms": cuda_ms(forward, 200),
        "twin_ms": cuda_ms(lambda: mk.material_coefficients_reference(
            data.mid, data.inv_len, lf, mat), reps),
        "torch_form_ms": cuda_ms(torch_form, reps),
        "kernel_backward_ms": cuda_ms(backward, 200),
        "kernel_backward_s_only_ms": cuda_ms(lambda: backward(s_only), 200),
        "plain_backward_ms": cuda_ms(
            lambda: mk.material_coefficients_backward_reference(
                data.mid, data.inv_len, lf, params, scales, widths, got[0],
                got[1], tuple(c)), 5),
        "kernel_host_us": host_us(forward),
        "kernel_backward_host_us": host_us(backward),
    }
    # Device us per launch (torch.profiler over 20 calls of each), and
    # device kernels per backward call.
    for label, fn, symbol in (
            ("kernel", forward, "material_forward_kernel"),
            ("kernel_backward", backward, "material_grad_kernel"),
            ("kernel_backward_s_only", lambda: backward(s_only),
             "material_grad_kernel")):
        ev, windows = recorded_window(
            lambda: [fn() for _ in range(20)],
            enough=lambda ev: sum(launched(e.name, symbol) for e in ev) >= 15)
        mine = [e.device_time_total for e in ev if launched(e.name, symbol)]
        others = sorted({e.name[:80] for e in ev
                         if not launched(e.name, symbol)})
        out[f"{label}_device_us"] = sum(mine) / max(len(mine), 1)
        out[f"{label}_device_ops_per_call"] = len(ev) / 20
        out[f"{label}_other_device_ops"] = others
        out[f"{label}_profiler_windows"] = windows
        # The profiler may drop the first records of a window (full runs
        # on the card saw 18 and 19 of the 20 launches), and adds none: so
        # every recorded device op must be this kernel, and most of the
        # launches must be there.
        require(not others and 15 <= len(mine) <= 20,
                f"one device kernel ({symbol}) per {label} call: {len(mine)} "
                f"launches and {len(ev)} device ops recorded in 20 calls, "
                f"others {others}")
    with torch.enable_grad():
        for t in theta:
            t.requires_grad_(True)
        for label, fn in (("twin", lambda: mk.material_coefficients_reference(
                data.mid, data.inv_len, lf, mat)), ("torch_form", torch_form)):
            loss = sum(torch.sum(ci * o) for ci, o in zip(c, fn()))
            out[f"{label}_backward_ms"] = cuda_ms(
                lambda: torch.autograd.grad(loss, theta, retain_graph=True),
                reps)
        for t in theta:
            t.requires_grad_(False)
    return out


def sync_cost_ms(dev, reps: int = 200) -> float:
    """Host ms of one small device result read back (the GD loop's one
    sync per iteration) on an otherwise idle card."""
    import torch

    x = torch.ones(6, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        (x * 2.0).tolist()
    return 1e3 * (time.perf_counter() - t0) / reps


def gd_profile(doc, dev, iters: int = 20) -> dict:
    """torch.profiler over `iters` GD iterations of the document: device
    busy time, wall time, and device time by kernel name (top 8)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pinn_fem_tpu_torch.io.schema import parse_problem_dict
    from pinn_fem_tpu_torch.solvers.gd import solve_gd

    parsed = parse_problem_dict(doc)
    data = parsed.problem.to_device(dev)
    cfg = parsed.config.with_(max_iterations=iters)
    args = (parsed.measured_disp, parsed.measured_dofs)
    solve_gd(parsed.problem, cfg, *args, data=data)        # warm-up
    parsed = parse_problem_dict(doc)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solve_gd(parsed.problem, cfg, *args, data=data)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if getattr(e, "device_time_total", 0) > 0
              and getattr(e, "device_type", None)
              == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.device_time_total for e in events)
    top = sorted(events, key=lambda e: -e.device_time_total)[:8]
    host = sorted((e for e in prof.key_averages()
                   if getattr(e, "device_type", None)
                   == torch.autograd.DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)[:10]
    return {"iterations": iters, "wall_ms": 1e3 * wall,
            "device_busy_ms": busy_us / 1e3,
            "device_idle_share": (1 - busy_us / 1e3 / (1e3 * wall)
                                  if busy_us else None),
            "top_device_kernels_us": {e.key[:60]: e.device_time_total
                                      for e in top},
            "top_host_ops_self_us_calls": {
                e.key[:60]: [e.self_cpu_time_total, e.count] for e in host}}


def phase_gd_main_path(workdir: Path, dev):
    """The PINN grid document through main() on cuda: launches, loss,
    ms per GD iteration, the first CPU_ROWS rows against the CPU twin."""
    import numpy as np
    import torch

    from pinn_fem_tpu_torch.cli.generic import main, run
    from pinn_fem_tpu_torch.examples_grid import pinn_grid_document
    from pinn_fem_tpu_torch.io.schema import parse_problem_dict
    from pinn_fem_tpu_torch.ops import kernels
    from pinn_fem_tpu_torch.solvers.gd import solve_gd

    doc = pinn_grid_document(*GRID, max_iterations=GD_ITERS)
    path = workdir / "pinn_grid.json"
    path.write_text(json.dumps(doc))
    os.environ["PINN_FEM_TORCH_DEVICE"] = DEVICE

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pinn_fem_tpu_torch.cli.generic", str(path)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    cold_s = time.perf_counter() - t0
    require(proc.returncode == 0,
            f"cold PINN CLI run exit code 0, got {proc.returncode}:\n"
            f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    rc = main([str(path)])
    first_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    require(rc == 0, "PINN CLI exit code 0")
    out = json.loads((workdir / "pinn_grid.res.json").read_text())
    hist = out["history"]
    n_it = len(hist)
    require(n_it == GD_ITERS or out["converged"],
            "GD ran its budget or converged")
    require(launches["material_coefficients"] == n_it + 1,
            "one forward kernel per GD iteration, one for the reactions")
    require(launches["material_coefficients_backward"] == n_it,
            "one backward kernel per GD iteration")
    loss = [e["loss_total"] for e in hist]
    require(bool(np.all(np.isfinite(loss))) and loss[-1] < 0.2 * loss[0],
            "loss_total finite and falls")
    u = np.asarray(out["displacements"], float)
    require(bool(np.all(np.isfinite(u))) and u.size == 2 * GRID[0] * GRID[1],
            "finite displacements of the expected shape")
    measured = np.zeros(u.size)
    measured[doc["measured_displacements"]["global_dof"]] = \
        doc["measured_displacements"]["measured_u"]
    u_rel = float(np.abs(u - measured).max() / np.abs(measured).max())

    t0 = time.perf_counter()
    require(main([str(path)]) == 0, "warm PINN CLI run exit code 0")
    warm_s = time.perf_counter() - t0
    again = json.loads((workdir / "pinn_grid.res.json").read_text())
    repeat = again["history"] == hist

    # ms per GD iteration: the solver alone, 100 iterations, warm.
    parsed = parse_problem_dict(doc)
    data = parsed.problem.to_device(dev)
    cfg = parsed.config.with_(max_iterations=100)
    solve_gd(parse_problem_dict(doc).problem, cfg.with_(max_iterations=5),
             parsed.measured_disp, parsed.measured_dofs, data=data)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solve_gd(parsed.problem, cfg, parsed.measured_disp,
                   parsed.measured_dofs, data=data)
    torch.cuda.synchronize()
    ms_per_iter = 1e3 * (time.perf_counter() - t0) / len(res.history)
    profile = gd_profile(doc, dev)

    # The same document on the CPU (the twin) for CPU_ROWS iterations.
    cpu_doc = dict(doc, pinn_config=dict(doc["pinn_config"],
                                         max_iterations=CPU_ROWS))
    cpu_path = workdir / "pinn_grid_cpu.json"
    cpu_path.write_text(json.dumps(cpu_doc))
    t0 = time.perf_counter()
    cpu = run(str(cpu_path), device="cpu")
    cpu_s = time.perf_counter() - t0
    keys = list(hist[0])
    hc = np.array([[e[k] for k in keys] for e in cpu["history"]])
    hg = np.array([[e[k] for k in keys] for e in hist[:CPU_ROWS]])
    scale = np.maximum(np.abs(hc).max(axis=0), 1e-30)
    col_err = np.abs(hg - hc).max(axis=0) / scale
    first_err = float((np.abs(hg[0] - hc[0]) / scale).max())
    rows_err = dict(zip(keys, col_err.tolist()))
    log("phase7_gd_main_path", ndof=u.size, elements=len(doc["elements"]),
        exit_code=rc, converged=out["converged"], history_length=n_it,
        first_loss_total=loss[0], last_loss_total=loss[-1],
        u_rel_err_vs_measured=u_rel, ms_per_gd_iteration=ms_per_iter,
        sync_ms=sync_cost_ms(dev), cold_process_s=cold_s,
        first_in_process_s=first_s, warm_s=warm_s,
        warm_history_bit_equal=repeat, launches=launches,
        cpu_twin_rows=len(cpu["history"]), cpu_twin_s=cpu_s,
        card_vs_cpu_max_rel_err=rows_err, card_vs_cpu_first_row=first_err,
        profile=profile)
    require(len(cpu["history"]) == CPU_ROWS, "CPU twin run length")
    require(first_err <= GD_FIRST_ROW_RTOL,
            f"first row within {GD_FIRST_ROW_RTOL} of the CPU twin")
    require(rows_err["theta_norm"] <= GD_THETA_RTOL,
            f"theta_norm within {GD_THETA_RTOL} of the CPU twin")
    require(max(col_err) <= GD_ROWS_RTOL,
            f"first {CPU_ROWS} rows within {GD_ROWS_RTOL} of the CPU twin")
    return {k: launches[k] for k in MATERIAL}


def phase_gd_corpus(workdir: Path):
    """Corpus example2 (scalar GD, 141 iterations) and example7-P (hybrid,
    three NN fields, the JAX CLI's initial weights) on cuda.  example7-P's
    count (96 on the CPU, as in JAX) is reported, not gated: the card's
    float32 sums steer Adam's first steps (PERF.md)."""
    import numpy as np

    from pinn_fem_tpu_torch.cli.generic import main
    from pinn_fem_tpu_torch.ops import kernels

    for name, bound_u, pinned in (("example2", 4e-3, 141),
                                  ("example7-P", 2e-4, None)):
        path = workdir / f"{name}.json"
        path.write_text((ROOT / "examples" / "json" / f"{name}.json")
                        .read_text())
        kernels.reset_launch_counts()
        require(main([str(path)]) == 0, f"{name} exit code 0")
        launches = kernels.launch_counts()
        out = json.loads((workdir / f"{name}.res.json").read_text())
        ux = np.asarray(out["displacements"]).reshape(-1, 2)[:, 0]
        err = float(np.abs(ux - np.arange(len(ux))).max())
        require(out["converged"] is True, f"{name} converged")
        require(err <= bound_u * max(1.0, len(ux) - 1),
                f"{name} displacements within {bound_u} x max(1, L)")
        if pinned is not None:
            require(out["iterations"] == pinned, f"{name} {pinned} iterations")
        log("phase8_corpus", document=name, converged=True,
            iterations=out["iterations"], max_abs_err=err,
            launches={k: launches[k] for k in MATERIAL})


def main() -> int:
    card = phase_card()
    phase_build()
    import torch

    dev = torch.device(DEVICE)
    stats = phase_kernels(dev)
    with tempfile.TemporaryDirectory() as tmp:
        launches = phase_main_path(Path(tmp))
        phase_dense(Path(tmp))
        mat_stats = phase_material(dev)
        launches.update(phase_gd_main_path(Path(tmp), dev))
        phase_gd_corpus(Path(tmp))

    grid = dict(stats["grid_40k"], **mat_stats)
    entries = []
    for name, (source, replaces) in KERNELS.items():
        err = (max(stats[m][name]["err"] for m in stats if name in stats[m])
               if name in BANDED
               else mat_stats[name]["err"])
        k = grid[name]
        entries.append({
            "name": name, "route": "cuda", "source": CSRC + source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err, "ms": k["ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k["library_ms"], "device_us": k.get("device_us"),
            "wrapper_ms": k.get("wrapper_ms"),
            **{key: k[key] for key in ("host_us", "twin_ms", "s_only_ms",
                                       "s_only_device_us", "s_only_bound_ms")
               if key in k},
        })
    print(card, flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
