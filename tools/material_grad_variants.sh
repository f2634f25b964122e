#!/bin/bash
# Where the material backward kernel (4b) spends its time, without a
# profiler that reads the kernel's insides: build variants of
# csrc/material.cu with one part of material_grad_kernel switched off and
# time each with tools/measure_material_grad.py (device us per call at the
# 100 x 200 grid's 79,102 elements and on a 1,000,000-element chain, all
# four upstream gradients and gs alone).  A variant's gradient is wrong by
# design; only its time is read.  Also prints ptxas's registers and spills
# of the kernel for each variant.  Run from the repository root on a
# machine with the card and nvcc:
#
#     bash tools/material_grad_variants.sh [variant ...]
#
# Variants: base (the source as it is), noepi (no cross-block sums: each
# block returns after writing its partials), noelem (no element pass),
# noparam (no parameter pass), notanh (tanhf replaced by a multiply),
# blocks4 (launch bounds of 4 blocks an SM).  Copies go to build/variants/.
set -u
SRC=pinn_fem_tpu_torch/ops/kernels/csrc/material.cu
NVCC=${CUDA_HOME:-/usr/local/cuda}/bin/nvcc
declare -A EDIT=(
  [base]=''
  [noepi]='s|^  // Groups of group_size blocks: the last block of a group to finish sums|  return;\n  // Groups|'
  [noelem]='s|^      if (t < rows)$|      if (t < rows \&\& a.n < 0)|'
  [noparam]='s|^      if (owner) {|      if (owner \&\& a.n < 0) {|'
  [notanh]='s|^#include <stdint.h>|#include <stdint.h>\n#define tanhf(v) ((v) * 0.5f)|'
  [blocks4]='s/kGradMinBlocks = 3;/kGradMinBlocks = 4;/'
)
names=("$@")
[ ${#names[@]} -eq 0 ] && names=(base noepi noelem noparam notanh blocks4)
for name in "${names[@]}"; do
  d=build/variants/$name
  rm -rf "$d"; mkdir -p "$d"
  cp -r pinn_fem_tpu_torch "$d/"
  touch "$d/pyproject.toml"
  [ -n "${EDIT[$name]}" ] && sed -i "${EDIT[$name]}" "$d/$SRC"
  if cmp -s "$SRC" "$d/$SRC" && [ "$name" != base ]; then
    echo "$name: the edit did not apply"; continue
  fi
  "$NVCC" -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false \
      -Xptxas -v -c -o "$d/material.o" "$d/$SRC" 2>&1 \
    | grep -A3 material_grad_kernel | grep -E "spill|Used" | sed "s/^/$name ptxas: /"
  python3 tools/measure_material_grad.py --root "$d" --label "$name" 2>/dev/null \
    | python3 -c '
import json, sys
for line in sys.stdin:
    r = json.loads(line)
    if "mesh" in r:
        print(r["label"], r["mesh"], "device_us all_four",
              round(r["all_four"]["device_us_per_call"], 2), "s_only",
              round(r["s_only"]["device_us_per_call"], 2))
    else:
        print(r["label"], r["card"])
'
done
