// MLP material fields at element midpoints, forward and backward, for
// Hopper (sm_90a).
//
//   pft_material_forward    (E, A, rho, s = E * A / L) at every element
//       replaces pinn_fem_tpu/ops/pallas/material_kernel.py:_material_kernel
//   pft_material_backward   d loss / d theta from the upstream gradients of
//                           (E, A, rho, s)
//       replaces the JAX autodiff of ops/assembly.material_values (the TPU
//       kernel had no backward: JAX differentiated the XLA path)
//
// The three nets (young, area, density) each map the input row
// (load_factor, x, y) through 1 or 2 tanh hidden layers of width <= 32 to
// one output o, and the field value is softplus(o) * scale.  Their
// parameters come as one flat float32 array, net after net, each net as
// W1 (3, h1) row-major, b1 (h1), [W2 (h1, h2) row-major, b2 (h2),]
// W3 (h_last, 1), b3 (1): the order of the trainable parameters in
// pinn_fem_tpu_torch/solvers/gd.py, so the gradient comes out in the
// layout of theta itself.  Widths are the nets' own: nothing is padded.
//
// Forward: one thread per element, all three nets' weights in shared
// memory (at most 3 * 1217 floats).  Per element the nets at widths
// 20/15/10 cost about 1,900 flops and 90 tanhf against 28 bytes of
// traffic, so the kernel is bound by arithmetic, not by memory; the
// simple design keeps every activation in registers / L1 and reads the
// weights from shared memory only.
//
// Backward: blocks of kTile threads walk tiles of kTile elements.  For one
// net at a time each thread recomputes its element's activations and
// backpropagates to per-element deltas, which it writes as one row of a
// shared-memory table; then each thread owns some of the net's parameters
// and sums their outer-product terms over the tile's rows in row order.
// Tile sums accumulate in float64 per block, in tile order, and a second
// pass sums the per-block partials in block order: no atomics, so runs
// repeat bit for bit.  The work is about twice the forward's arithmetic
// plus n_params multiply-adds per element.
//
// Numerics: float32 with the accurate tanhf/expf/log1pf (no fast-math
// approximations) and no tensor cores.  The library is built with
// --fmad=false; the dot products here ask for fused multiply-adds
// explicitly with fmaf.  softplus(o) = log1p(exp(-|o|)) + max(o, 0); its
// derivative is the logistic function.
//
// Each entry point selects the device, launches on the given stream and
// returns cudaGetLastError() as an int (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFields = 3;
constexpr int kInputs = 3;       // (load_factor, x, y)
constexpr int kMaxWidth = 32;
constexpr int kForwardThreads = 256;
constexpr int kTile = 128;       // backward: elements per tile = threads per block
constexpr int kMaxGradBlocks = 264;  // backward grid: 2 blocks per SM of an H100

struct Nets {
  int h1[kFields];
  int h2[kFields];      // 0: one hidden layer
  int offset[kFields];  // first parameter of each net in the flat array
  int n_params;
  int max_h1;
  int max_h2;
};

__host__ __device__ inline int net_params(int h1, int h2) {
  const int last = h2 > 0 ? h2 : h1;
  return kInputs * h1 + h1 + (h2 > 0 ? h1 * h2 + h2 : 0) + last + 1;
}

__device__ __forceinline__ float softplus(float o) {
  return log1pf(expf(-fabsf(o))) + fmaxf(o, 0.0f);
}

__device__ __forceinline__ float logistic(float o) {
  if (o >= 0.0f) return 1.0f / (1.0f + expf(-o));
  const float e = expf(o);
  return e / (1.0f + e);
}

// One net's raw output at input x; the hidden activations are written to
// a1[j * stride] and (two hidden layers) a2[j * stride].
__device__ float net_forward(const float* __restrict__ p, int h1, int h2,
                             const float* x, float* a1, float* a2,
                             int stride) {
  const float* w1 = p;
  const float* b1 = w1 + kInputs * h1;
  for (int j = 0; j < h1; ++j) {
    float acc = 0.0f;
    for (int k = 0; k < kInputs; ++k) acc = fmaf(x[k], w1[k * h1 + j], acc);
    a1[j * stride] = tanhf(acc + b1[j]);
  }
  const float* q = b1 + h1;
  const float* last = a1;
  int width = h1;
  if (h2 > 0) {
    const float* w2 = q;
    const float* b2 = w2 + h1 * h2;
    for (int j = 0; j < h2; ++j) {
      float acc = 0.0f;
      for (int i = 0; i < h1; ++i) acc = fmaf(a1[i * stride], w2[i * h2 + j], acc);
      a2[j * stride] = tanhf(acc + b2[j]);
    }
    q = b2 + h2;
    last = a2;
    width = h2;
  }
  float acc = 0.0f;
  for (int j = 0; j < width; ++j) acc = fmaf(last[j * stride], q[j], acc);
  return acc + q[width];
}

__device__ __forceinline__ void load_input(const float* __restrict__ mid,
                                           int dim, float lf, int64_t i,
                                           float* x) {
  x[0] = lf;
  x[1] = mid[i * dim];
  x[2] = dim > 1 ? mid[i * dim + 1] : 0.0f;
}

__global__ void __launch_bounds__(kForwardThreads)
material_forward_kernel(const float* __restrict__ mid, int dim,
                        const float* __restrict__ inv_len, float lf,
                        int64_t n, const float* __restrict__ params,
                        const float* __restrict__ scales, Nets nets,
                        float* __restrict__ e_out, float* __restrict__ a_out,
                        float* __restrict__ rho_out,
                        float* __restrict__ s_out) {
  extern __shared__ float w[];
  for (int k = threadIdx.x; k < nets.n_params; k += blockDim.x) w[k] = params[k];
  __syncthreads();
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float x[kInputs];
  load_input(mid, dim, lf, i, x);
  float a1[kMaxWidth], a2[kMaxWidth];
  float v[kFields];
  for (int f = 0; f < kFields; ++f) {
    const float o = net_forward(w + nets.offset[f], nets.h1[f], nets.h2[f], x,
                                a1, a2, 1);
    v[f] = softplus(o) * scales[f];
  }
  e_out[i] = v[0];
  a_out[i] = v[1];
  rho_out[i] = v[2];
  s_out[i] = v[0] * v[1] * inv_len[i];
}

// Row strides of the backward's shared tables: odd, so that the rows
// written by the threads of a warp fall in different banks.
__host__ __device__ inline int odd_stride(int width) {
  return width + 1 - (width & 1);
}

__host__ __device__ inline int stride_h2(const Nets& nets) {
  return nets.max_h2 > 0 ? odd_stride(nets.max_h2) : 0;
}

// Shared memory of the backward: float64 gradient accumulators, the
// weights, and per tile row x (kInputs), a1 and d1 (h1-wide), a2 and d2
// (h2-wide) and d_out.
__host__ inline size_t grad_shared_bytes(const Nets& nets) {
  const int row = kInputs + 2 * odd_stride(nets.max_h1) + 2 * stride_h2(nets) + 1;
  return sizeof(double) * nets.n_params
         + sizeof(float) * (nets.n_params + (size_t)kTile * row);
}

__global__ void __launch_bounds__(kTile)
material_grad_kernel(const float* __restrict__ mid, int dim,
                     const float* __restrict__ inv_len, float lf, int64_t n,
                     const float* __restrict__ params,
                     const float* __restrict__ scales, Nets nets,
                     const float* __restrict__ e_val,
                     const float* __restrict__ a_val,
                     const float* __restrict__ g_e,
                     const float* __restrict__ g_a,
                     const float* __restrict__ g_rho,
                     const float* __restrict__ g_s,
                     double* __restrict__ partial) {
  extern __shared__ double smem[];
  double* gacc = smem;                                   // n_params
  float* w = reinterpret_cast<float*>(gacc + nets.n_params);  // n_params
  float* tab = w + nets.n_params;
  const int s1 = odd_stride(nets.max_h1);
  const int s2 = stride_h2(nets);
  float* xs = tab;                    // (kTile, kInputs)
  float* a1s = xs + kTile * kInputs;    // (kTile, s1)
  float* d1s = a1s + kTile * s1;        // (kTile, s1)
  float* a2s = d1s + kTile * s1;        // (kTile, s2)
  float* d2s = a2s + kTile * s2;        // (kTile, s2)
  float* dos = d2s + kTile * s2;        // (kTile,)

  const int t = threadIdx.x;
  for (int k = t; k < nets.n_params; k += kTile) {
    w[k] = params[k];
    gacc[k] = 0.0;
  }
  __syncthreads();

  const int64_t n_tiles = (n + kTile - 1) / kTile;
  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int64_t i = tile * kTile + t;
    const bool valid = i < n;
    float* x = xs + t * kInputs;
    float dv[kFields] = {0.0f, 0.0f, 0.0f};
    if (valid) {
      load_input(mid, dim, lf, i, x);
      const float gs = g_s != nullptr ? g_s[i] : 0.0f;
      dv[0] = (g_e != nullptr ? g_e[i] : 0.0f) + gs * a_val[i] * inv_len[i];
      dv[1] = (g_a != nullptr ? g_a[i] : 0.0f) + gs * e_val[i] * inv_len[i];
      dv[2] = g_rho != nullptr ? g_rho[i] : 0.0f;
    } else {
      x[0] = x[1] = x[2] = 0.0f;
    }
    for (int f = 0; f < kFields; ++f) {
      const float* p = w + nets.offset[f];
      const int h1 = nets.h1[f], h2 = nets.h2[f];
      float* a1 = a1s + t * s1;
      float* d1 = d1s + t * s1;
      float* a2 = a2s + t * s2;
      float* d2 = d2s + t * s2;
      // Element pass: activations and deltas of this thread's element.
      const float o = net_forward(p, h1, h2, x, a1, a2, 1);
      const float d_out = dv[f] * logistic(o) * scales[f];
      dos[t] = d_out;
      const float* w1b = p + kInputs * h1 + h1;  // W2, or W3 with one layer
      if (h2 > 0) {
        const float* w3 = w1b + h1 * h2 + h2;
        for (int j = 0; j < h2; ++j)
          d2[j] = d_out * w3[j] * (1.0f - a2[j] * a2[j]);
        for (int k = 0; k < h1; ++k) {
          float acc = 0.0f;
          for (int j = 0; j < h2; ++j) acc = fmaf(w1b[k * h2 + j], d2[j], acc);
          d1[k] = acc * (1.0f - a1[k] * a1[k]);
        }
      } else {
        for (int k = 0; k < h1; ++k)
          d1[k] = d_out * w1b[k] * (1.0f - a1[k] * a1[k]);
      }
      __syncthreads();

      // Parameter pass: each thread sums its parameters' terms over the
      // tile's rows, in row order.
      // Ends of the net's parameter groups in its flat layout.
      const int end_w1 = kInputs * h1;
      const int end_b1 = end_w1 + h1;
      const int end_w2 = end_b1 + (h2 > 0 ? h1 * h2 : 0);
      const int end_b2 = end_w2 + h2;
      const int end_w3 = end_b2 + (h2 > 0 ? h2 : h1);  // then b3
      for (int q = t; q <= end_w3; q += kTile) {
        // term(row) = left[row * ls] * right[row * rs], or right alone (bias)
        const float* left = nullptr;
        const float* right = dos;
        int ls = 0, rs = 1;
        if (q < end_w1) {                 // W1[k][j]: x_k d1_j
          left = xs + q / h1; ls = kInputs;
          right = d1s + q % h1; rs = s1;
        } else if (q < end_b1) {          // b1[j]: d1_j
          right = d1s + (q - end_w1); rs = s1;
        } else if (q < end_w2) {          // W2[k][j]: a1_k d2_j
          left = a1s + (q - end_b1) / h2; ls = s1;
          right = d2s + (q - end_b1) % h2; rs = s2;
        } else if (q < end_b2) {          // b2[j]: d2_j
          right = d2s + (q - end_w2); rs = s2;
        } else if (q < end_w3) {          // W3[j]: a_last_j d_out
          left = (h2 > 0 ? a2s : a1s) + (q - end_b2);
          ls = h2 > 0 ? s2 : s1;
        }                                 // b3: d_out
        float acc = 0.0f;
        if (left != nullptr) {
          for (int row = 0; row < kTile; ++row)
            acc = fmaf(left[row * ls], right[row * rs], acc);
        } else {
          for (int row = 0; row < kTile; ++row) acc += right[row * rs];
        }
        gacc[nets.offset[f] + q] += (double)acc;
      }
      __syncthreads();
    }
  }
  for (int k = t; k < nets.n_params; k += kTile)
    partial[(int64_t)blockIdx.x * nets.n_params + k] = gacc[k];
}

// grad[k] = sum over blocks of partial[b, k], in block order.
__global__ void material_grad_reduce_kernel(const double* __restrict__ partial,
                                            int n_blocks, int n_params,
                                            float* __restrict__ grad) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n_params) return;
  double acc = 0.0;
  for (int b = 0; b < n_blocks; ++b) acc += partial[(int64_t)b * n_params + k];
  grad[k] = (float)acc;
}

// Nets from the host's widths array [h1_0, h2_0, h1_1, h2_1, h1_2, h2_2];
// false when a width is out of range.
bool make_nets(const int* widths, Nets* nets) {
  int offset = 0;
  nets->max_h1 = nets->max_h2 = 0;
  for (int f = 0; f < kFields; ++f) {
    const int h1 = widths[2 * f], h2 = widths[2 * f + 1];
    if (h1 < 1 || h1 > kMaxWidth || h2 < 0 || h2 > kMaxWidth) return false;
    nets->h1[f] = h1;
    nets->h2[f] = h2;
    nets->offset[f] = offset;
    offset += net_params(h1, h2);
    nets->max_h1 = h1 > nets->max_h1 ? h1 : nets->max_h1;
    nets->max_h2 = h2 > nets->max_h2 ? h2 : nets->max_h2;
  }
  nets->n_params = offset;
  return true;
}

int64_t grad_blocks(int64_t n) {
  const int64_t tiles = (n + kTile - 1) / kTile;
  return tiles < kMaxGradBlocks ? (tiles > 0 ? tiles : 1) : kMaxGradBlocks;
}

}  // namespace

extern "C" {

// Number of flat parameters of nets with these widths; -1 if out of range.
int pft_material_n_params(const int* widths) {
  Nets nets;
  return make_nets(widths, &nets) ? nets.n_params : -1;
}

// Rows of the backward's (blocks, n_params) float64 partials buffer.
int64_t pft_material_grad_blocks(int64_t n) { return grad_blocks(n); }

int pft_material_forward(int device, const float* mid, int dim,
                         const float* inv_len, float lf, int64_t n,
                         const float* params, const float* scales,
                         const int* widths, float* e, float* a, float* rho,
                         float* s, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Nets nets;
  if (!make_nets(widths, &nets) || dim < 1 || dim > 2)
    return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const unsigned int blocks =
        (unsigned int)((n + kForwardThreads - 1) / kForwardThreads);
    material_forward_kernel<<<blocks, kForwardThreads,
                              sizeof(float) * nets.n_params,
                              (cudaStream_t)stream>>>(
        mid, dim, inv_len, lf, n, params, scales, nets, e, a, rho, s);
  }
  return (int)cudaGetLastError();
}

// partial: (pft_material_grad_blocks(n), n_params) float64 scratch;
// grad: (n_params,) float32.  Absent upstream gradients are null.
int pft_material_backward(int device, const float* mid, int dim,
                          const float* inv_len, float lf, int64_t n,
                          const float* params, const float* scales,
                          const int* widths, const float* e, const float* a,
                          const float* g_e, const float* g_a,
                          const float* g_rho, const float* g_s,
                          double* partial, float* grad, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Nets nets;
  if (!make_nets(widths, &nets) || dim < 1 || dim > 2)
    return (int)cudaErrorInvalidValue;
  const size_t smem = grad_shared_bytes(nets);
  err = cudaFuncSetAttribute(material_grad_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (int)grad_blocks(n);
  material_grad_kernel<<<blocks, kTile, smem, (cudaStream_t)stream>>>(
      mid, dim, inv_len, lf, n, params, scales, nets, e, a, g_e, g_a, g_rho,
      g_s, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  material_grad_reduce_kernel<<<(nets.n_params + 255) / 256, 256, 0,
                                (cudaStream_t)stream>>>(
      partial, blocks, nets.n_params, grad);
  return (int)cudaGetLastError();
}

}  // extern "C"
