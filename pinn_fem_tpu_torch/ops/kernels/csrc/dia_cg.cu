// Banded (DIA) stencil and fused Jacobi-PCG kernels for Hopper (sm_90a).
//
// Three kernels share one stencil routine:
//
//   pft_dia_matvec      y[i] = sum_k d[k, i] * u[i + off_k]
//       replaces pinn_fem_tpu/ops/pallas/dia_kernel.py:_dia_kernel
//   pft_dia_dir_matvec  p_new = z + beta * p ; ap = mask * (K p_new) ;
//                       per-block sum(p_new * ap)
//       replaces pinn_fem_tpu/ops/pallas/cg_kernel.py:_dir_matvec_kernel
//   pft_cg_update       x += alpha p ; r -= alpha ap ; z = inv_diag * r ;
//                       per-block sum(r * z), sum(r * r)
//       replaces pinn_fem_tpu/ops/pallas/cg_kernel.py:_update_kernel
//
// Layout: the diagonals stay (nd, ndof) row-major and the offsets are a
// device int64 array of length nd (nd may be as large as 192, so nothing is
// unrolled by a fixed count).  One thread owns one output row; for each
// diagonal k the threads of a warp read d[k, i..i+31] and u[i+off_k ..],
// both contiguous, so every load is coalesced.  Reads outside [0, ndof) are
// masked to zero, which is what the zero padding of the plain version does.
//
// What bounds them on this card: memory.  Each output row costs nd + 2
// floats of traffic in the matvec, nd + 5 in the direction kernel and 8 in
// the update, against one multiply-add per diagonal, far below the point
// where arithmetic would matter.  The simple design does two things about
// it: one pass over every vector per kernel (the direction update and the
// dot-product partials ride inside the stencil pass, as on the TPU), and
// the neighbour reads of u / z / p, which repeat across the nd diagonals,
// are left to L1/L2 instead of being staged by hand.
//
// Numerics: built with --fmad=false, so `acc + d * v` rounds the product
// and the sum separately, exactly as the plain PyTorch versions do with
// separate multiply and add operations.  The diagonals are summed in order
// k = 0..nd-1, so the matvec and the direction kernel's p_new and ap are
// bit-identical to their plain versions.  Block partials are summed by a
// shared-memory tree (no atomics), so results repeat from run to run.
//
// Early exit: the two CG kernels take a device stop flag (one byte).  When
// it is set they return without writing, which freezes the solver state
// while the host polls the flag only every few iterations.
//
// Each entry point selects the device, launches on the given stream and
// returns cudaGetLastError() as an int (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // power of two: the tree reductions need it

struct PlainLoad {
  const float* __restrict__ u;
  __device__ __forceinline__ float operator()(int64_t j) const { return u[j]; }
};

// p_new at any row, rebuilt from z and p (pointwise in beta), so that the
// direction kernel needs no separate pass for the update of p.
struct DirectionLoad {
  const float* __restrict__ z;
  const float* __restrict__ p;
  float beta;
  __device__ __forceinline__ float operator()(int64_t j) const {
    return z[j] + beta * p[j];
  }
};

template <typename Load>
__device__ __forceinline__ float stencil_row(const float* __restrict__ diags,
                                             const int64_t* __restrict__ offsets,
                                             int nd, int64_t ndof, int64_t i,
                                             const Load& load) {
  float acc = 0.0f;
  for (int k = 0; k < nd; ++k) {
    const int64_t j = i + offsets[k];
    const float v = (j >= 0 && j < ndof) ? load(j) : 0.0f;
    acc = acc + diags[(int64_t)k * ndof + i] * v;
  }
  return acc;
}

// Sum of buf[0..kThreads) into buf[0]; every thread of the block calls it.
__device__ __forceinline__ void block_sum(float* buf) {
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) buf[threadIdx.x] = buf[threadIdx.x] + buf[threadIdx.x + s];
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
dia_matvec_kernel(const float* __restrict__ diags,
                  const int64_t* __restrict__ offsets, int nd, int64_t ndof,
                  const float* __restrict__ u, float* __restrict__ y) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= ndof) return;
  y[i] = stencil_row(diags, offsets, nd, ndof, i, PlainLoad{u});
}

__global__ void __launch_bounds__(kThreads)
dia_dir_matvec_kernel(const float* __restrict__ beta_ptr,
                      const float* __restrict__ z, const float* __restrict__ p,
                      const float* __restrict__ diags,
                      const int64_t* __restrict__ offsets, int nd, int64_t ndof,
                      const float* __restrict__ mask,
                      float* __restrict__ p_out, float* __restrict__ ap_out,
                      float* __restrict__ partial,
                      const unsigned char* __restrict__ stop) {
  if (stop != nullptr && *stop) return;  // uniform over the grid
  __shared__ float buf[kThreads];
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const DirectionLoad load{z, p, *beta_ptr};
  float prod = 0.0f;
  if (i < ndof) {
    const float pn = load(i);
    const float ap = stencil_row(diags, offsets, nd, ndof, i, load) * mask[i];
    p_out[i] = pn;
    ap_out[i] = ap;
    prod = pn * ap;
  }
  buf[threadIdx.x] = prod;
  block_sum(buf);
  if (threadIdx.x == 0) partial[blockIdx.x] = buf[0];
}

// x, r and z are updated in place (the TPU kernel returned new arrays):
// each thread reads and writes only its own row, so no other thread can
// observe a half-updated vector.
__global__ void __launch_bounds__(kThreads)
cg_update_kernel(const float* __restrict__ alpha_ptr, float* __restrict__ x,
                 float* __restrict__ r, const float* __restrict__ p,
                 const float* __restrict__ ap,
                 const float* __restrict__ inv_diag, float* __restrict__ z,
                 int64_t n, float* __restrict__ partial,
                 const unsigned char* __restrict__ stop) {
  if (stop != nullptr && *stop) return;
  __shared__ float rz_buf[kThreads];
  __shared__ float rr_buf[kThreads];
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const float alpha = *alpha_ptr;
  float rz = 0.0f, rr = 0.0f;
  if (i < n) {
    const float xi = x[i] + alpha * p[i];
    const float ri = r[i] - alpha * ap[i];
    const float zi = inv_diag[i] * ri;
    x[i] = xi;
    r[i] = ri;
    z[i] = zi;
    rz = ri * zi;
    rr = ri * ri;
  }
  rz_buf[threadIdx.x] = rz;
  rr_buf[threadIdx.x] = rr;
  block_sum(rz_buf);
  block_sum(rr_buf);
  if (threadIdx.x == 0) {
    partial[2 * (int64_t)blockIdx.x] = rz_buf[0];
    partial[2 * (int64_t)blockIdx.x + 1] = rr_buf[0];
  }
}

inline unsigned int n_blocks(int64_t n) {
  return (unsigned int)((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

int pft_threads_per_block() { return kThreads; }

const char* pft_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int pft_dia_matvec(int device, const float* diags, const int64_t* offsets,
                   int nd, int64_t ndof, const float* u, float* y,
                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (ndof > 0) {
    dia_matvec_kernel<<<n_blocks(ndof), kThreads, 0, (cudaStream_t)stream>>>(
        diags, offsets, nd, ndof, u, y);
  }
  return (int)cudaGetLastError();
}

int pft_dia_dir_matvec(int device, const float* beta, const float* z,
                       const float* p, const float* diags,
                       const int64_t* offsets, int nd, int64_t ndof,
                       const float* mask, float* p_out, float* ap_out,
                       float* partial, const unsigned char* stop,
                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (ndof > 0) {
    dia_dir_matvec_kernel<<<n_blocks(ndof), kThreads, 0,
                            (cudaStream_t)stream>>>(
        beta, z, p, diags, offsets, nd, ndof, mask, p_out, ap_out, partial,
        stop);
  }
  return (int)cudaGetLastError();
}

int pft_cg_update(int device, const float* alpha, float* x, float* r,
                  const float* p, const float* ap, const float* inv_diag,
                  float* z, int64_t n, float* partial,
                  const unsigned char* stop, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    cg_update_kernel<<<n_blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
        alpha, x, r, p, ap, inv_diag, z, n, partial, stop);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
