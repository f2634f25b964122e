#!/usr/bin/env python3
"""Time the PCG direction kernel (kernel 2, dia_dir_matvec) on one NVIDIA
card, at the 100 x 200 grid's 40,000 DOFs (the Newton path) and on the
1,000,001-node chain's 2,000,002 DOFs (the 2M PCG iteration).

    python3 tools/measure_dir_matvec.py [--root CHECKOUT] [--label NAME]
                                        [--plans 1x256,1x128,...]

--root imports pinn_fem_tpu_torch from another checkout (for example a
parent commit unpacked with git archive), so that two versions are
measured on one card in one call.  For each mesh: kernel 2 against its
plain twin (bit for bit), ms per call of the launch bound once as the PCG
loop calls it (CUDA events over 200 calls after a warm-up), device us per
launch (torch.profiler over 50 launches), its bound (bytes at 3.35 TB/s,
as chip_smoke.py counts them) and the share of it, and ms per fused PCG
iteration (300 iterations at tol 0, CUDA events) with the device us per
launch of both PCG kernels in a profiled window of 64 iterations.
--plans also times kernel 2 under other partitions, ROWSxTHREADS[xPASSES]
(checkouts with dia_kernel.direction_plan only), each checked bit for bit
against the twin under the same partition.  Prints one JSON line per mesh
and one with the card.  Needs a CUDA card; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPS = 200
PROFILED = 50
PCG_ITERS = 300
BYTES_PER_S = 3.35e12


def cuda_ms(fn, reps: int) -> float:
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


def device_us(fn, calls: int, symbol: str):
    """(launches seen, device us per launch) of the kernel `symbol` over
    `calls` calls of fn, from the first of three profiler windows that
    recorded it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        mine = [e.device_time_total for e in prof.events()
                if getattr(e, "device_type", None)
                == torch.autograd.DeviceType.CUDA
                and (symbol + "(" in e.name or symbol + "<" in e.name)]
        if mine:
            return len(mine), sum(mine) / len(mine)
    return 0, None


def bound_ms(layout, n_partials: int) -> float:
    """Kernel 2's least time: the diagonals, the offsets, z, p, mask and
    beta read once, p_new, ap and the partials written once."""
    nd, n = layout.n_diags, layout.ndof
    return 1e3 * (4 * nd * n + 4 * nd + 4 * 5 * n + 4 * n_partials + 4) \
        / BYTES_PER_S


def systems(dev):
    from pinn_fem_tpu_torch.examples_grid import chain_problem, grid_problem
    from pinn_fem_tpu_torch.ops.cg import stiffness_coefficients
    from pinn_fem_tpu_torch.ops.dia import assemble_dia, dia_layout

    for name, problem in (("grid_40k", grid_problem(100, 200)),
                          ("chain_2M", chain_problem(1_000_001))):
        data = problem.to_device(dev)
        layout = dia_layout(data.dof_map.cpu().numpy(), problem.ndof)
        diags = assemble_dia(
            layout, stiffness_coefficients(data, problem.material, 1.0),
            data.gvec)
        yield name, data, layout, diags


def forced_plans(spec: str):
    """[(rows, threads, passes), ...] from 'RxT[xP],...'."""
    out = []
    for item in filter(None, spec.split(",")):
        parts = [int(v) for v in item.split("x")]
        out.append((parts[0], parts[1], parts[2] if len(parts) > 2 else 1))
    return out


def use_plan(layout, form):
    """Make kernel 2 and its twin take the partition `form` on `layout`
    (None: direction_plan's own); returns the plan."""
    from pinn_fem_tpu_torch.ops.kernels import cg_kernel, dia_kernel

    own = getattr(dia_kernel, "_own_direction_plan", None)
    if own is None:
        own = dia_kernel._own_direction_plan = dia_kernel.direction_plan
    plan = own(layout)
    if form is None:
        chosen = own
    else:
        rows, threads, passes = form
        tile = rows * threads * passes
        plan = dia_kernel.DirectionPlan(
            threads=threads, tile=tile, halo_lo=plan.halo_lo,
            halo_hi=plan.halo_hi,
            window=tile + plan.halo_lo + plan.halo_hi if plan.staged else 0,
            staged=plan.staged, n_diags=plan.n_diags, ndof=plan.ndof,
            rows=rows)

        def chosen(_layout, plan=plan):
            return plan
    for module in (dia_kernel, cg_kernel):
        module.direction_plan = chosen
    for key in [k for k in layout._on_device if k[0] == "direction"]:
        del layout._on_device[key]
    return plan


def kernel2(layout, diags, data, dev, gen):
    """Kernel 2 against its twin, ms and device us of the bound launch."""
    import torch

    from pinn_fem_tpu_torch.ops.kernels import cg_kernel

    n = layout.ndof
    z, p = (torch.randn(n, generator=gen, device=dev) for _ in range(2))
    beta = torch.tensor(0.37, device=dev)
    mask = data.free_mask
    got = cg_kernel.dia_dir_matvec(beta, z, p, layout, diags, mask)
    want = cg_kernel.dir_matvec_reference(beta, z, p, layout, diags, mask)
    equal = all(torch.equal(a, b) for a, b in zip(got, want))
    launch, _ = cg_kernel.bind_dir_matvec(beta, z, p, layout, diags, mask,
                                          out=tuple(torch.empty_like(t)
                                                    for t in got))
    ms = cuda_ms(launch, REPS)
    seen, us = device_us(launch, PROFILED, "dia_dir_matvec_kernel")
    b = bound_ms(layout, got[2].numel())
    return {"bit_equal": equal, "partials": got[2].numel(), "ms": ms,
            "device_us": us, "launches_profiled": seen, "bound_ms": b,
            "share_of_bound": (1e3 * b / us) if us else None}


def pcg(layout, diags, data, dev):
    """ms per fused PCG iteration at tol 0 and the two kernels' device us
    per launch in a profiled window of 64 iterations."""
    import torch

    from pinn_fem_tpu_torch.ops.kernels import fused_cg_solve

    if layout.ndof > 100_000:  # the chain: x of node 0 and every y pinned
        mask = torch.ones(layout.ndof, device=dev)
        mask[0] = 0.0
        mask[1::2] = 0.0
        rhs = torch.zeros(layout.ndof, device=dev)
        rhs[-2] = 1.0
    else:
        mask, rhs = data.free_mask, data.loads
    ms = cuda_ms(lambda: fused_cg_solve(layout, diags, rhs, mask, tol=0.0,
                                        max_iter=PCG_ITERS), 1) / PCG_ITERS
    out = {"pcg_ms_per_iteration": ms}
    for name, symbol in (("dir", "dia_dir_matvec_kernel"),
                         ("update", "cg_update_kernel")):
        seen, us = device_us(lambda: fused_cg_solve(
            layout, diags, rhs, mask, tol=0.0, max_iter=64), 1, symbol)
        out[f"pcg_{name}_device_us"] = us
        out[f"pcg_{name}_launches_profiled"] = seen
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="change")
    ap.add_argument("--plans", default="")
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    import torch

    from pinn_fem_tpu_torch.ops.kernels import _build, dia_kernel

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    _build.load_library()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    has_plan = hasattr(dia_kernel, "direction_plan")
    for name, data, layout, diags in systems(dev):
        row = {"label": args.label, "mesh": name, "ndof": layout.ndof,
               "n_diags": layout.n_diags}
        if has_plan:
            plan = dia_kernel.direction_plan(layout)
            row["plan"] = {k: getattr(plan, k) for k in (
                "rows", "threads", "tile", "blocks", "staged",
                "shared_bytes")}
        row.update(kernel2(layout, diags, data, dev, gen))
        row.update(pcg(layout, diags, data, dev))
        variants = {}
        for form in (forced_plans(args.plans) if has_plan else []):
            if layout.ndof < 100_000 and form[0] * form[1] * form[2] > 1024:
                continue
            plan = use_plan(layout, form)
            k = kernel2(layout, diags, data, dev, gen)
            variants["x".join(map(str, form))] = dict(
                blocks=plan.blocks, warps_per_sm=plan.blocks * plan.threads
                / 32 / dia_kernel.SMS, **k)
        if variants:
            use_plan(layout, None)
            row["variants"] = variants
        print(json.dumps(row), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(json.dumps({"label": args.label, "card": smi.stdout.strip(),
                      "torch": torch.__version__}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
