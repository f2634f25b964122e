#!/bin/bash
# Kernel 4 (the material forward kernel) of this checkout against a parent
# checkout on one card, in turns (parent, change, change, parent), then
# this checkout's kernel under other launch forms (elements a thread x
# threads a block), then source variants of this checkout's kernel, all
# with tools/measure_material_forward.py; then the instruction floor from
# the SASS (tools/material_forward_sass.py).  Also prints ptxas's
# registers and spills of every kernel in csrc/material.cu (the parent's
# too) and of the forward kernels of each variant.  Run from the repository root on a
# machine with the card and nvcc, the parent unpacked beforehand (git
# archive) into a directory .gitignore lists ("-" for none):
#
#     bash tools/material_forward_variants.sh build/parent [FORMS] [VARIANT ...]
#
# FORMS: comma-separated ELEMENTSxTHREADS for the PINN grid's nets (two
# elements a thread, threads a multiple of 32 up to 256; default below);
# "-" for none.  Variants (each
# one's outputs are wrong by design; only its time is read): notanh (tanhf
# replaced by a multiply), nolds (every weight load replaced by a
# constant), nolds2 (the layer-2 weight loads replaced by constants).
# Copies go to build/variants/.
set -u
PARENT=${1:?usage: material_forward_variants.sh PARENT_CHECKOUT [FORMS] [VARIANT ...]}
FORMS=${2:-2x64,2x128,2x256}
shift $(( $# < 2 ? $# : 2 ))
SRC=pinn_fem_tpu_torch/ops/kernels/csrc/material.cu
NVCC=${CUDA_HOME:-/usr/local/cuda}/bin/nvcc
declare -A EDIT=(
  [notanh]='s|^#include <stdint.h>|#include <stdint.h>\n#define tanhf(v) ((v) * 0.5f)|'
  [nolds]='s|^  return \*reinterpret_cast<const float4\*>(p);|  return make_float4(1e-3f, 2e-3f, 3e-3f, 4e-3f);|'
  [nolds2]='s|const float4 u = lds4(w2 + i \* P + 4 \* q);|const float4 u = make_float4(1e-3f * i, 2e-3f * q, 3e-3f, 4e-3f);|'
)
ptxas() {
  mkdir -p build/ptxas
  "$NVCC" -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false \
      -Xptxas -v -c -o build/ptxas/material.o "$1" 2>&1 \
    | grep -E "Compiling entry function|spill|Used" \
    | sed -e "s/.*Compiling entry function '[^']*material_cu_[0-9a-f]*\([^']*\)'.*/\1/" \
    | paste - - - | sed "s/^/$2 ptxas: /"
}
ptxas "$SRC" base
[ "$PARENT" != - ] && ptxas "$PARENT/$SRC" parent
if [ "$PARENT" != - ]; then
  for run in parent change change parent; do
    root=.
    [ "$run" = parent ] && root=$PARENT
    python3 tools/measure_material_forward.py --root "$root" --label "$run" \
      || exit 1
  done
fi
if [ "$FORMS" != - ]; then
  python3 tools/measure_material_forward.py --label forms --forms "$FORMS" \
    || exit 1
fi
for name in "$@"; do
  d=build/variants/$name
  rm -rf "$d"; mkdir -p "$d"
  cp -r pinn_fem_tpu_torch "$d/"
  touch "$d/pyproject.toml"
  sed -i "${EDIT[$name]}" "$d/$SRC"
  if cmp -s "$SRC" "$d/$SRC"; then
    echo "$name: the edit did not apply"; continue
  fi
  ptxas "$d/$SRC" "$name" | grep forward
  python3 tools/measure_material_forward.py --root "$d" --label "$name" \
    || exit 1
done
python3 tools/material_forward_sass.py
[ "$PARENT" != - ] && python3 tools/material_forward_sass.py --kernels-only \
  "$PARENT/$SRC" | sed "s/^/parent /"
