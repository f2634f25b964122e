#!/usr/bin/env python3
"""Instruction floor of the material forward kernel (kernel 4) on one
NVIDIA card: the instructions an element issues, counted from the SASS of
probe kernels built from csrc/material.cu with the library's own nvcc
flags, and the least time those take at the card's issue rates.

    python3 tools/material_forward_sass.py [--kernels-only SOURCE]

A probe kernel runs the kernel's per-element body for compile-time shapes
(the three nets through net_forward, softplus, the scales and s = E A / L)
on E elements a thread, with its weights in shared memory as the kernel
has them; a baseline probe does the same loads and stores without the
nets.  nvcc builds both to a cubin; cuobjdump -sass lists them; the
difference over E is the count an element, by class: every instruction
(the issue), FP32 (FFMA, FADD, FMUL, FMNMX, FSEL, FSETP, ...) and MUFU.
Every loop of the body is unrolled, so the static count is the dynamic
one, except where a libdevice function branches (both paths count).  At
the card's highest SM clock (nvidia-smi clocks.max.sm) an SM issues 4 warp
instructions a clock (128 thread instructions), 128 FP32 lanes and 16 MUFU
results a clock (sm_90); the floor of n elements is the largest of
(count x n) / (rate x SMs x clock) over the three classes.  Prints one JSON
line per probe and one with the card, then one per kernel of the source
with its SASS instruction count and code bytes (16 bytes an
instruction).  --kernels-only SOURCE builds another material.cu (a
parent checkout's) without the probes and prints only its kernels' lines.
Needs nvcc and cuobjdump (and the card for its clock and SM count);
imports no JAX.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# (quads of the three nets, two hidden layers): the PINN grid's widths
# 20 / 15 / 10 at both depths, and the widest nets.
SHAPES = (((5, 4, 3), True), ((5, 4, 3), False), ((8, 8, 8), True))
FP32 = {"FFMA", "FADD", "FMUL", "FMNMX", "FSEL", "FSETP", "FSET", "FCHK",
        "FRND", "FSWZADD"}
PER_CLOCK = {"issue": 128, "fp32": 128, "mufu": 16}   # thread ops, SM
ELEMENTS = (79_102, 1_000_000)

PROBE = r'''
#include "{source}"

template <int Q0, int Q1, int Q2, bool kTwo, int E>
__global__ void probe(const float* __restrict__ in, float* __restrict__ out,
                      float lf) {{
  extern __shared__ float4 probe_smem[];
  const float* w = reinterpret_cast<const float*>(probe_smem);
  const int t = threadIdx.x;
  float x1[E], x2[E], il[E], v[3][E];
#pragma unroll
  for (int e = 0; e < E; ++e) {{
    x1[e] = in[t + 32 * e];
    x2[e] = in[t + 32 * e + 64];
    il[e] = in[t + 32 * e + 128];
  }}
  {{
    float a1[E][4 * Q0], a2[E][4 * Q0], o[E];
    net_forward<Q0, kTwo, E>(w, lf, x1, x2, a1, a2, o);
#pragma unroll
    for (int e = 0; e < E; ++e) v[0][e] = softplus(o[e]) * in[192];
  }}
  {{
    float a1[E][4 * Q1], a2[E][4 * Q1], o[E];
    net_forward<Q1, kTwo, E>(w + 2048, lf, x1, x2, a1, a2, o);
#pragma unroll
    for (int e = 0; e < E; ++e) v[1][e] = softplus(o[e]) * in[193];
  }}
  {{
    float a1[E][4 * Q2], a2[E][4 * Q2], o[E];
    net_forward<Q2, kTwo, E>(w + 4096, lf, x1, x2, a1, a2, o);
#pragma unroll
    for (int e = 0; e < E; ++e) v[2][e] = softplus(o[e]) * in[194];
  }}
#pragma unroll
  for (int e = 0; e < E; ++e) {{
    out[t + 32 * e] = v[0][e];
    out[t + 32 * e + 64] = v[1][e];
    out[t + 32 * e + 128] = v[2][e];
    out[t + 32 * e + 192] = v[0][e] * v[1][e] * il[e];
  }}
}}

template <int E>
__global__ void baseline(const float* __restrict__ in, float* __restrict__ out,
                         float lf) {{
  const int t = threadIdx.x;
#pragma unroll
  for (int e = 0; e < E; ++e) {{
    const float x1 = in[t + 32 * e], x2 = in[t + 32 * e + 64];
    const float il = in[t + 32 * e + 128];
    out[t + 32 * e] = x1 * in[192];
    out[t + 32 * e + 64] = x2 * in[193];
    out[t + 32 * e + 128] = lf * in[194];
    out[t + 32 * e + 192] = x1 * x2 * il;
  }}
}}

{instances}
'''


def probe_source() -> str:
    instances = []
    for e in (1, 2):
        instances.append(f"template __global__ void baseline<{e}>"
                         "(const float*, float*, float);")
        for (q0, q1, q2), two in SHAPES:
            instances.append(
                f"template __global__ void probe<{q0}, {q1}, {q2}, "
                f"{str(two).lower()}, {e}>(const float*, float*, float);")
    src = ROOT / "pinn_fem_tpu_torch/ops/kernels/csrc/material.cu"
    return PROBE.format(source=src, instances="\n".join(instances))


def sass_counts(cubin: Path, cuobjdump: str) -> dict:
    """{function name: Counter of opcodes} from cuobjdump -sass."""
    text = subprocess.run([cuobjdump, "-sass", str(cubin)], check=True,
                          capture_output=True, text=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z0-9_.]+)",
                     line)
        if m and name is not None:
            op = m.group(2).split(".")[0]
            if op != "NOP":
                out[name][op] += 1
    return out


def classes(c: Counter) -> dict:
    return {"issue": sum(c.values()),
            "fp32": sum(v for k, v in c.items() if k in FP32),
            "mufu": c.get("MUFU", 0)}


def demangled_shape(name: str):
    """(kind, quads, two, E) from a probe's or baseline's mangled name."""
    m = re.search(r"5probeILi(\d)ELi(\d)ELi(\d)ELb([01])ELi(\d)E", name)
    if m:
        q = tuple(int(m.group(k)) for k in (1, 2, 3))
        return "probe", q, m.group(4) == "1", int(m.group(5))
    m = re.search(r"8baselineILi(\d)E", name)
    if m:
        return "baseline", None, None, int(m.group(1))
    return None


def kernel_sizes(counts: dict) -> None:
    """One line per kernel of csrc/material.cu: instructions, code bytes."""
    for name, c in sorted(counts.items()):
        m = re.search(r"(material_(?:forward|grad)_kernel)(?:ILi(\d+)E)?",
                      name)
        if m:
            total = sum(c.values())
            kernel = m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")
            print(json.dumps({"kernel": kernel, "instructions": total,
                              "code_bytes": 16 * total}), flush=True)


def main() -> int:
    from pinn_fem_tpu_torch.ops.kernels import _build

    nvcc = _build._nvcc()
    cuobjdump = str(Path(nvcc).with_name("cuobjdump"))
    out_dir = ROOT / "build" / "sass_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC")]
    if len(sys.argv) == 3 and sys.argv[1] == "--kernels-only":
        cubin = out_dir / "kernels.cubin"
        subprocess.run([nvcc, *flags, "-cubin", "-o", str(cubin),
                        sys.argv[2]], check=True)
        kernel_sizes(sass_counts(cubin, cuobjdump))
        return 0
    src = out_dir / "probe.cu"
    src.write_text(probe_source())
    cubin = out_dir / "probe.cubin"
    subprocess.run([nvcc, *flags, "-cubin", "-o", str(cubin), str(src)],
                   check=True)
    counts = sass_counts(cubin, cuobjdump)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "?"
    clock_hz = float(card.split(",")[-1]) * 1e6 if smi else None
    sms = None
    try:
        import torch

        if torch.cuda.is_available():
            sms = torch.cuda.get_device_properties(0).multi_processor_count
    except ImportError:
        pass
    print(json.dumps({"card": card, "sms": sms, "clock_hz": clock_hz,
                      "per_clock_per_sm": PER_CLOCK}), flush=True)
    base = {}
    for name, c in counts.items():
        shape = demangled_shape(name)
        if shape and shape[0] == "baseline":
            base[shape[3]] = classes(c)
    for name, c in sorted(counts.items()):
        shape = demangled_shape(name)
        if not shape or shape[0] != "probe":
            continue
        _, quads, two, e = shape
        cls = classes(c)
        per_element = {k: (cls[k] - base[e][k]) / e for k in cls}
        row = {"quads": quads, "two_hidden_layers": two,
               "elements_a_thread": e, "per_element": per_element,
               "top_opcodes": dict(c.most_common(12))}
        if sms and clock_hz:
            for n in ELEMENTS:
                t = {k: 1e6 * per_element[k] * n
                     / (PER_CLOCK[k] * sms * clock_hz) for k in per_element}
                row[f"floor_us_{n}"] = t
        print(json.dumps(row), flush=True)
    kernel_sizes(counts)
    return 0


if __name__ == "__main__":
    sys.exit(main())
