#!/usr/bin/env python3
"""Time the port's material-field forward kernel (kernel 4) on one NVIDIA
card and fingerprint its outputs, at the 100 x 200 grid's 79,102 element
midpoints and on a 1,000,000-element chain, with three MLP fields of
widths 20 / 15 / 10 (the PINN grid's nets), one and two hidden layers, at
load factors 0.3 and 1.0.

    python3 tools/measure_material_forward.py [--root CHECKOUT] [--label NAME]
                                              [--forms 2x128,2x256,...]

--root imports pinn_fem_tpu_torch from another checkout (for example a
parent commit unpacked with git archive), so that two versions are
measured on one card in one call.  The weights are drawn with numpy from a
fixed seed, so every checkout gets the same inputs.  For each mesh, depth
and load factor: a sha256 of each output's bytes (E, A, rho, s), so that
two checkouts compare bit for bit across processes; the largest error
against the plain version (material_coefficients_reference) relative to
each output's largest value; and at load factor 1.0 ms per call (CUDA
events over 200 calls after a warm-up), device us per launch (torch.profiler
over 20 calls, the first of three windows that recorded at least 15 of
the launches) and host us per wrapper call (time.perf_counter around 200
calls after a synchronize; the calls only enqueue), device us per
launch again with each launch 3 ms after the card fell idle (as in the
GD loop, where the host's part of a step leaves the card idle), and the
SM clock and power draw nvidia-smi reads while 3,000 calls run.
Then the forward inside the GD loop of the grid as a PINN document (device
us per launch, host ms per GD iteration; `gd_loop`).  Checkouts with a
forward plan also print it and the kernel's registers
and local bytes a thread.  --forms (such checkouts only) times the kernel
again under other forms, ELEMENTSxTHREADS (elements a thread x threads a
block), each also fingerprinted.  Prints one JSON line per row and one
with the card.  Needs a CUDA card; imports no JAX.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

REPS = 200
PROFILED = 20
WIDTHS = (20, 15, 10)
SCALES = (2.0, 0.5, 7.0)
SYMBOL = "material_forward_kernel"


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


def host_us(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / reps


def device_us(fn, calls: int) -> dict:
    """Device us per launch of the forward kernel over `calls` calls, the
    launches recorded and any other device op, from the first of three
    profiler windows that recorded at least three quarters of the
    launches (on the card a window now and then drops records)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    for window in range(1, 4):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.events()
              if getattr(e, "device_type", None)
              == torch.autograd.DeviceType.CUDA
              and getattr(e, "device_time_total", 0) > 0]
        mine = [e.device_time_total for e in ev
                if SYMBOL + "(" in e.name or SYMBOL + "<" in e.name]
        if 4 * len(mine) >= 3 * calls:
            break
    return {"device_us": sum(mine) / max(len(mine), 1),
            "launches_recorded": len(mine), "windows": window,
            "other_device_ops": sorted({e.name[:60] for e in ev
                                        if SYMBOL not in e.name})}


def after_idle(fn, idle_s: float = 0.003):
    """fn launched after the card has been idle for idle_s, as a GD
    iteration launches the forward after the host's share of the step."""
    import torch

    def call():
        torch.cuda.synchronize()
        time.sleep(idle_s)
        return fn()

    return call


def clocks_under_load(fn, calls: int = 3000) -> dict:
    """The SM clock (MHz) and power draw (W) that nvidia-smi reads while
    `calls` calls of fn, enqueued beforehand, keep the card busy."""
    import torch

    torch.cuda.synchronize()
    for _ in range(calls):
        fn()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    torch.cuda.synchronize()
    clock, power = smi.stdout.strip().splitlines()[0].split(",")
    return {"sm_clock_mhz_under_load": float(clock),
            "power_w_under_load": float(power)}


def flat_params(hidden: int, seed: int = 7):
    """The three nets' flat parameters (W1, b1, [W2, b2,] W3, b3 each) and
    the widths, drawn with numpy: weights uniform in +-1/sqrt(fan in),
    biases uniform in +-0.1, the output layer scaled up so that the
    softplus sees both signs."""
    import numpy as np

    rng = np.random.default_rng(seed + hidden)
    parts, widths = [], []
    for h in WIDTHS:
        dims = [3] + [h] * hidden + [1]
        for k, (i, o) in enumerate(zip(dims, dims[1:])):
            gain = 3.0 if k == len(dims) - 2 else 1.0
            parts.append(gain * rng.uniform(-1, 1, i * o) / np.sqrt(i))
            parts.append(rng.uniform(-0.1, 0.1, o))
        widths += [h, h if hidden == 2 else 0]
    return np.concatenate(parts).astype(np.float32), tuple(widths)


def reference(mk, mid, inv_len, lf, params, widths):
    """The plain version on the same flat parameters."""
    import torch

    from pinn_fem_tpu_torch.models.fields import Material, MLPField

    fields, off = [], 0
    for f, scale in enumerate(SCALES):
        h1, h2 = widths[2 * f], widths[2 * f + 1]
        dims = [3, h1] + ([h2] if h2 else []) + [1]
        layers = []
        for i, o in zip(dims, dims[1:]):
            w = params[off:off + i * o].reshape(i, o)
            b = params[off + i * o:off + i * o + o]
            off += i * o + o
            layers.append((w, b))
        fields.append(MLPField(layers=layers, input_dim=3,
                               scale=torch.tensor(scale, device=mid.device),
                               enforce_positive=True))
    return mk.material_coefficients_reference(mid, inv_len, lf,
                                              Material(*fields))


def digest(t) -> str:
    return hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()[:16]


def forms_of(spec: str):
    return [tuple(int(v) for v in item.split("x"))
            for item in filter(None, spec.split(","))]


def measure(mesh: str, data, dev, forms) -> list:
    import torch

    from pinn_fem_tpu_torch.ops.kernels import material_kernel as mk

    rows = []
    own = getattr(mk, "forward_form", None)
    for hidden in (1, 2):
        p, widths = flat_params(hidden)
        params = torch.from_numpy(p).to(dev)
        scales = torch.tensor(SCALES, dtype=torch.float32, device=dev)
        for lf in (0.3, 1.0):
            def forward():
                return mk.material_coefficients(data.mid, data.inv_len, lf,
                                                params, scales, widths)

            for form in [None] + (forms if lf == 1.0 else []):
                if form is not None:
                    mk.forward_form = lambda *_, form=form: form
                    mk._FORWARD_PLANS.clear()
                got = forward()
                want = reference(mk, data.mid, data.inv_len, lf, params,
                                 widths)
                row = {"mesh": mesh, "elements": data.nelm,
                       "hidden_layers": hidden, "load_factor": lf,
                       "form": None if form is None else "x".join(
                           map(str, form)),
                       "sha256": [digest(t) for t in got],
                       "max_rel_err_vs_plain": [
                           float((a - b).abs().max() / b.abs().max())
                           for a, b in zip(got, want)],
                       "bit_equal_repeat": all(
                           torch.equal(a, b) for a, b in zip(got, forward()))}
                if hasattr(mk, "_forward_plan"):
                    plan, occ = mk._forward_plan(data.mid.device, widths,
                                                 data.nelm)
                    row["plan"] = plan._asdict()
                    row["blocks_per_sm"], _, row["registers"], \
                        row["local_bytes"] = occ
                if lf == 1.0:
                    idle = device_us(after_idle(forward), PROFILED)
                    row.update(ms=cuda_ms(forward, REPS),
                               host_us=host_us(forward, REPS),
                               **device_us(forward, PROFILED),
                               device_us_after_idle=idle["device_us"],
                               **clocks_under_load(forward))
                rows.append(row)
            if own is not None:
                mk.forward_form = own
                mk._FORWARD_PLANS.clear()
    return rows


def gd_loop(dev, iters: int = 20) -> dict:
    """The forward inside the GD loop: the 100 x 200 grid as a PINN
    document (examples_grid.pinn_grid_document, the nets of this tool's
    widths), `iters` GD iterations under torch.profiler after a warm-up of
    as many: device us per forward launch, launches recorded, and host ms
    per GD iteration (wall clock of the profiled run, over iters); and
    device us per launch of the forward called back to back on the
    document's initial weights."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pinn_fem_tpu_torch.examples_grid import pinn_grid_document
    from pinn_fem_tpu_torch.io.schema import parse_problem_dict
    from pinn_fem_tpu_torch.solvers.gd import solve_gd

    from pinn_fem_tpu_torch.ops.kernels import material_kernel as mk

    doc = pinn_grid_document(100, 200)
    parsed = parse_problem_dict(doc)
    data = parsed.problem.to_device(dev)
    material = parsed.problem.material.to(dev)
    alone = device_us(lambda: mk.fused_material_coefficients(
        data, material, 1.0), PROFILED)["device_us"]
    cfg = parsed.config.with_(max_iterations=iters)
    args = (parsed.measured_disp, parsed.measured_dofs)
    solve_gd(parsed.problem, cfg, *args, data=data)
    parsed = parse_problem_dict(doc)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solve_gd(parsed.problem, cfg, *args, data=data)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    mine = [e.device_time_total for e in prof.events()
            if getattr(e, "device_type", None)
            == torch.autograd.DeviceType.CUDA
            and (SYMBOL + "(" in e.name or SYMBOL + "<" in e.name)]
    return {"mesh": "pinn_grid_gd", "elements": data.nelm,
            "gd_iterations": iters,
            "device_us": sum(mine) / max(len(mine), 1),
            "launches_recorded": len(mine),
            "device_us_alone_initial_weights": alone,
            "ms_per_gd_iteration": 1e3 * wall / iters}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="change")
    ap.add_argument("--forms", default="")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    from pinn_fem_tpu_torch.examples_grid import chain_problem, grid_problem
    from pinn_fem_tpu_torch.ops.kernels import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    t0 = time.perf_counter()
    _build.load_library()
    print(json.dumps({"label": args.label, "card": smi,
                      "torch": torch.__version__,
                      "build_s": time.perf_counter() - t0}), flush=True)
    dev = torch.device("cuda")
    for mesh, problem in (("grid_79k", lambda: grid_problem(100, 200)),
                          ("chain_1M", lambda: chain_problem(1_000_001))):
        data = problem().to_device(dev)
        for row in measure(mesh, data, dev, forms_of(args.forms)):
            print(json.dumps({"label": args.label, **row}), flush=True)
        del data
        torch.cuda.empty_cache()
    print(json.dumps({"label": args.label, **gd_loop(dev)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
