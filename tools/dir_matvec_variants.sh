#!/bin/bash
# Kernel 2 (the PCG direction kernel) of this checkout against a parent
# checkout on one card, in turns (parent, change, change, parent), then
# source variants of this checkout's kernel, each under several
# partitions (rows a thread x threads a block [x passes]), all with
# tools/measure_dir_matvec.py.  Also prints ptxas's registers and spills
# of each instantiation of the kernel.  Run from the repository root on a
# machine with the card and nvcc, the parent unpacked beforehand (git
# archive) into a directory .gitignore lists ("-" for none):
#
#     bash tools/dir_matvec_variants.sh build/parent [PLANS] [VARIANT ...]
#
# PLANS: comma-separated ROWSxTHREADS[xPASSES], threads 32, 64 or 128
# (default below); plans wider than 1024 rows a block are skipped on the
# 40k grid.  Variants: base (the source as it is), stopfirst (the stop
# flag read before any copy is issued, as the first design did).  Copies
# go to build/variants/.
set -u
PARENT=${1:?usage: dir_matvec_variants.sh PARENT_CHECKOUT [PLANS]}
PLANS=${2:-1x128,1x64,2x128,2x64,4x64,4x128}
shift $(( $# < 2 ? $# : 2 ))
declare -A EDIT=(
  [base]=''
  [stopfirst]='s|^                  int halo_lo, int window, int staged) {$|&\n  if (stop != nullptr \&\& *stop) return;|'
)
names=("$@")
[ ${#names[@]} -eq 0 ] && names=(base)
SRC=pinn_fem_tpu_torch/ops/kernels/csrc/dia_cg.cu
NVCC=${CUDA_HOME:-/usr/local/cuda}/bin/nvcc
mkdir -p build/ptxas
"$NVCC" -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false \
    -Xptxas -v -c -o build/ptxas/dia_cg.o "$SRC" 2>&1 \
  | grep -A3 "Compiling entry function '.*dir_matvec" \
  | grep -E "Compiling|Used|spill" \
  | sed -e "s/.*kernelILi\([0-9]\)ELi\([0-9]*\)E.*/R=\1 T=\2/" \
  | paste - - - | sed "s/^/ptxas: /"
if [ "$PARENT" != - ]; then
  for run in parent change change parent; do
    root=.
    [ "$run" = parent ] && root=$PARENT
    python3 tools/measure_dir_matvec.py --root "$root" --label "$run" || exit 1
  done
fi
for name in "${names[@]}"; do
  d=build/variants/$name
  rm -rf "$d"; mkdir -p "$d"
  cp -r pinn_fem_tpu_torch "$d/"
  touch "$d/pyproject.toml"
  [ -n "${EDIT[$name]}" ] && sed -i "${EDIT[$name]}" "$d/$SRC"
  if cmp -s "$SRC" "$d/$SRC" && [ "$name" != base ]; then
    echo "$name: the edit did not apply"; continue
  fi
  python3 tools/measure_dir_matvec.py --root "$d" --label "$name" \
      --plans "$PLANS" || exit 1
done
