#!/usr/bin/env python3
"""Time the port's material-field kernels on one NVIDIA card: kernel 4
(the forward) and its backward (4b), at the 100 x 200 grid's 79,102
element midpoints and on a 1,000,000-element chain, three MLP fields of
widths 20 / 15 / 10 with two hidden layers (the PINN grid's nets).

    python3 tools/measure_material_grad.py [--root CHECKOUT] [--label NAME]

--root imports pinn_fem_tpu_torch from another checkout (for example a
parent commit unpacked with git archive), so that two versions are
measured on one card in one call.  For each mesh and each upstream (all
four of E, A, rho, s, and s alone, as on the GD path): ms per call (CUDA
events over 200 calls after a warm-up), device us per call and device
kernels per call (torch.profiler over 20 calls), and host us per wrapper
call (time.perf_counter around 200 calls after a synchronize; the calls
only enqueue).  Where the checkout has the backward's plain version
(material_coefficients_backward_reference), the kernel is also held to it
and to the twin's autograd, and two calls are compared bit for bit.
Prints one JSON line per mesh and one with the card.  Needs a CUDA card;
imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

REPS = 200
PROFILED = 20


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


def device_profile(fn, calls: int) -> dict:
    """Device kernels and device us per call of fn under torch.profiler,
    with the kernels' names."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if getattr(e, "device_type", None)
              == torch.autograd.DeviceType.CUDA
              and getattr(e, "device_time_total", 0) > 0]
    return {"device_ops_per_call": len(events) / calls,
            "device_us_per_call": sum(e.device_time_total
                                      for e in events) / calls,
            "names": sorted({e.name[:40] for e in events})}


def mlp_material(dev):
    """chip_smoke.py's nets: widths 20, 15, 10, two hidden layers, seeded
    torch draws, the last layer perturbed."""
    import torch

    from pinn_fem_tpu_torch import Material, make_mlp_field

    g = torch.Generator().manual_seed(2)
    fields = []
    for width, scale in ((20, 2.0), (15, 0.5), (10, 7.0)):
        f = make_mlp_field(g, hidden_layers=2, neurons_per_layer=width,
                           input_dim=3, scale=scale)
        w, b = f.layers[-1]
        f.layers[-1] = (w + 0.3 * torch.randn(w.shape, generator=g), b)
        fields.append(f)
    return Material(*fields).to(dev)


def measure(label: str, data, dev) -> dict:
    import torch

    from pinn_fem_tpu_torch.ops.kernels import material_kernel as mk
    from pinn_fem_tpu_torch.solvers.gd import get_theta

    mat = mlp_material(dev)
    params = torch.cat([t.reshape(-1) for f in mk._fields(mat)
                        for t in f.trainable_params()])
    scales = torch.stack([f.scale for f in mk._fields(mat)])
    widths = mk._widths(mat)
    n, lf = data.nelm, 1.0
    c = torch.randn(4, n, device=dev,
                    generator=torch.Generator(dev).manual_seed(5))
    e, a, _, _ = mk.material_coefficients(data.mid, data.inv_len, lf, params,
                                          scales, widths)

    def forward():
        return mk.material_coefficients(data.mid, data.inv_len, lf, params,
                                        scales, widths)

    out = {"mesh": label, "elements": n,
           "forward": {"ms": cuda_ms(forward, REPS),
                       "host_us": host_us(forward, REPS),
                       **device_profile(forward, PROFILED)}}
    for name, grads in (("all_four", tuple(c)),
                        ("s_only", (None, None, None, c[3]))):
        def backward(grads=grads):
            return mk.material_coefficients_backward(
                data.mid, data.inv_len, lf, params, scales, widths, e, a,
                grads)

        row = {"ms": cuda_ms(backward, REPS),
               "host_us": host_us(backward, REPS),
               **device_profile(backward, PROFILED)}
        got = backward()
        row["bit_equal_repeat"] = bool(torch.equal(got, backward()))
        if hasattr(mk, "material_coefficients_backward_reference"):
            ref = mk.material_coefficients_backward_reference(
                data.mid, data.inv_len, lf, params, scales, widths, e, a,
                grads)
            scale = float(ref.abs().max())
            row["max_rel_err_vs_plain"] = float((got - ref).abs().max()) / scale
            theta = [t for layers in get_theta(mat) for layer in layers
                     for t in layer]
            with torch.enable_grad():
                for t in theta:
                    t.requires_grad_(True)
                vals = mk.material_coefficients_reference(
                    data.mid, data.inv_len, lf, mat)
                loss = sum(torch.sum(g * v) for g, v in zip(grads, vals)
                           if g is not None)
                twin = torch.autograd.grad(loss, theta, allow_unused=True)
                for t in theta:
                    t.requires_grad_(False)
            twin = torch.cat([torch.zeros_like(t).reshape(-1) if g is None
                              else g.reshape(-1)
                              for t, g in zip(theta, twin)])
            row["max_rel_err_vs_twin"] = (float((got - twin).abs().max())
                                          / float(twin.abs().max()))
            if grads[2] is None:
                row["density_block_zero"] = bool(
                    (got[-mat.density.n_params():] == 0).all())
        out[name] = row
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="change")
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
    for label, problem in (("grid_79k", lambda: grid_problem(100, 200)),
                           ("chain_1M", lambda: chain_problem(1_000_001))):
        data = problem().to_device(dev)
        print(json.dumps({"label": args.label,
                          **measure(label, data, dev)}), flush=True)
        del data
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
