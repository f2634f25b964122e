// MLP material fields at element midpoints, forward and backward, for
// Hopper (sm_90a).
//
//   pft_material_forward    (E, A, rho, s = E * A / L) at every element
//       replaces pinn_fem_tpu/ops/pallas/material_kernel.py:_material_kernel
//   pft_material_backward   d loss / d theta from the upstream gradients of
//                           (E, A, rho, s), one launch
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
// layout of theta itself.
//
// Forward: one thread per element, all three nets' weights in shared
// memory (at most 3 * 1217 floats).  Per element the nets at widths
// 20/15/10 cost about 1,900 flops and 90 tanhf against 28 bytes of
// traffic, so the kernel is bound by arithmetic, not by memory; the
// simple design keeps every activation in registers / L1 and reads the
// weights from shared memory only.
//
// Backward (material_grad_kernel): bound by arithmetic as well, about
// twice the forward's plus one multiply-add per parameter and element.
// Blocks of kTile threads; the grid is as many blocks as the card holds
// at once (occupancy x SMs, at most one per kTile elements), and block b
// takes the contiguous elements [b n / B, (b + 1) n / B), kTile at a time
// (its last tile may be short), so the blocks' loads differ by at most
// one element.  The block walks the nets one at a time; for each net:
//   * its weights, zero-padded to P = 4 Q columns (Q quads: the wider
//     hidden layer rounded up to 4; a padded unit's activation is
//     tanh(0) = 0 and its delta 0, so it adds exact zeros), are in shared
//     memory, where the block put all three nets' at its start;
//   * element pass: each thread takes one element of the tile, keeps its
//     activations in registers (the routine is a template on Q and the
//     depth, so the arrays have compile-time sizes) and writes one table
//     row: X = (lf, x, y, 1), O = (d_out, 1, 0, 0), a1, d1[, a2, d2], as
//     float4, at a row stride of an odd number of quads (the eight
//     threads of a 16-byte store phase hit distinct banks);
//   * parameter pass: every parameter term is an entry of a 4 x 4 outer
//     product of two quads of a row, summed over the tile's rows: X x d1
//     gives W1 and b1, a1 x d2 gives W2, a_last x O gives W3, d2 x O
//     gives b2, O x O gives b3 (the other entries are not parameters and
//     are dropped).  A thread owns one such job and one slice of the rows
//     for the whole net pass: per row it loads two float4 (broadcast
//     within the row) for 16 fmaf, sums its rows in row order in float32,
//     and adds each tile's sum to 16 float64 registers in tile order.  At
//     the end of the net the slices are added in slice order.
// Each block writes its float64 partials; the last block of each group of
// about sqrt(B) blocks (ticket after __threadfence) sums its group's rows
// in block order, and the last group sums the groups in group order into
// the float32 gradient and resets the tickets.  Those sums keep 32 loads
// in flight a thread (one block reads B / sqrt(B) rows of n_params
// doubles: its latency, not its bytes, is what a single block pays).  No
// atomics touch a sum, so runs repeat bit for bit, and a backward call is
// one kernel.
//
// A net whose upstream gradient is absent is skipped: young when gE and
// gs are null, area when gA and gs are null, density when grho is null.
// Its delta would be exactly zero at every element, so its gradient is
// exactly zero, which the kernel writes without computing it: the same
// function, not an approximation.
//
// Numerics: float32 with the accurate tanhf/expf/log1pf (no fast-math
// approximations) and no tensor cores.  The library is built with
// --fmad=false; the dot products here ask for fused multiply-adds
// explicitly with fmaf.  softplus(o) = log1p(exp(-|o|)) + max(o, 0); its
// derivative is the logistic function.
//
// Each entry point launches on the given stream and returns
// cudaGetLastError() as an int (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFields = 3;
constexpr int kInputs = 3;       // (load_factor, x, y)
constexpr int kMaxWidth = 32;
constexpr int kForwardThreads = 256;
constexpr int kTile = 128;       // backward: elements per tile = threads per block
// Backward: blocks an SM the launch bounds ask for.  3 gives 168 registers
// a thread (12 warps an SM); at 4 (16 warps) the 128-register cap spills
// and the grid's call runs slower (PERF.md, tools/material_grad_variants.sh).
constexpr int kGradMinBlocks = 3;
constexpr int kJobSize = 16;     // backward: a 4 x 4 outer product a job

struct Nets {
  int h1[kFields];
  int h2[kFields];      // 0: one hidden layer
  int offset[kFields];  // first parameter of each net in the flat array
  int n_params;
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

// ------------------------------------------------------------ backward

// One net's shape in the backward: both hidden layers padded to P = 4 q.
struct GradNet {
  int q;        // quads of the padded width
  int two;      // two hidden layers
  int stride;   // table row in floats: X, O, a1, d1[, a2, d2], one pad quad
  int n_jobs;   // 4 x 4 outer products of the parameter pass
  int slices;   // row slices a job is cut into (slices * n_jobs <= kTile)
};

__host__ __device__ inline GradNet grad_net(int h1, int h2) {
  GradNet g;
  const int h = h2 > h1 ? h2 : h1;
  g.q = (h + 3) / 4;
  g.two = h2 > 0 ? 1 : 0;
  g.stride = 4 * (3 + (g.two ? 4 : 2) * g.q);
  // W1 and b1: q; [W2: q * q; b2: q;] W3: q; b3: 1.  At most 89 < kTile.
  g.n_jobs = g.two ? g.q * g.q + 3 * g.q + 1 : 2 * g.q + 1;
  g.slices = kTile / g.n_jobs;
  return g;
}

// Floats of a net's padded weights: W1 [3][P], b1 [P], [W2 [P][P],
// b2 [P],] W3 [P], b3 (one quad).  Every group starts on a quad.
__host__ __device__ inline int padded_size(const GradNet& g) {
  const int p = 4 * g.q;
  return 5 * p + 4 + (g.two ? p * p + p : 0);
}

// Shared memory of the backward: the three nets' padded weights, net
// after net, then the tables of kTile rows (reused as the float64 slice
// sums).
__host__ inline int grad_weight_floats(const Nets& nets) {
  int w = 0;
  for (int f = 0; f < kFields; ++f)
    w += padded_size(grad_net(nets.h1[f], nets.h2[f]));
  return w;
}

__host__ inline size_t grad_shared_bytes(const Nets& nets) {
  int stride = 0;
  for (int f = 0; f < kFields; ++f) {
    const int s = grad_net(nets.h1[f], nets.h2[f]).stride;
    stride = s > stride ? s : stride;
  }
  const size_t tables = sizeof(float) * kTile * stride;
  const size_t slices = sizeof(double) * kTile * kJobSize;
  return sizeof(float) * grad_weight_floats(nets)
         + (tables > slices ? tables : slices);
}

// The largest shared memory any widths need (32 wide, two layers).
constexpr size_t kGradMaxShared =
    sizeof(float) * kFields * (6 * 32 + 4 + 32 * 32)
    + sizeof(float) * kTile * 4 * (3 + 4 * 8);

// Position in a net's padded weights of its flat parameter j.
__device__ __forceinline__ int padded_slot(int h1, int h2, const GradNet& g,
                                           int j) {
  const int pw = 4 * g.q;
  if (j < 3 * h1) return (j / h1) * pw + j % h1;     // W1
  j -= 3 * h1;
  if (j < h1) return 3 * pw + j;                     // b1
  j -= h1;
  int base = 4 * pw;
  if (g.two) {
    if (j < h1 * h2) return base + (j / h2) * pw + j % h2;  // W2
    j -= h1 * h2;
    base += pw * pw;
    if (j < h2) return base + j;                     // b2
    j -= h2;
    base += pw;
  }
  return base + (j < (g.two ? h2 : h1) ? j : pw);    // W3, then b3
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void sts4(float* p, float a, float b, float c,
                                     float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// Component k of v; k is a constant once the loops are unrolled.
__device__ __forceinline__ float lane(const float4& v, int k) {
  return k == 0 ? v.x : (k == 1 ? v.y : (k == 2 ? v.z : v.w));
}

template <int P>
__device__ __forceinline__ void store_quads(float* dst, const float (&v)[P]) {
#pragma unroll
  for (int q = 0; q < P / 4; ++q)
    sts4(dst + 4 * q, v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
}

// sum_j h[j] w3[j] + b3, in order.
template <int P>
__device__ __forceinline__ float output(const float (&h)[P],
                                        const float* w3, const float* b3) {
  float acc = 0.0f;
#pragma unroll
  for (int q = 0; q < P / 4; ++q) {
    const float4 u = lds4(w3 + 4 * q);
#pragma unroll
    for (int k = 0; k < 4; ++k) acc = fmaf(h[4 * q + k], lane(u, k), acc);
  }
  return acc + b3[0];
}

// Element pass of one net for one element: activations and deltas in
// registers, then the element's table row.  w: the padded weights.
template <int Q, bool kTwo>
__device__ __forceinline__ void element_row(const float* __restrict__ w,
                                            float x0, float x1, float x2,
                                            float dv, float scale,
                                            float* __restrict__ row) {
  constexpr int P = 4 * Q;
  const float* w1 = w;
  const float* b1 = w1 + 3 * P;
  const float* w2 = b1 + P;
  const float* b2 = w2 + P * P;
  const float* w3 = kTwo ? b2 + P : b1 + P;
  const float* b3 = w3 + P;
  float a1[P];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const float4 u0 = lds4(w1 + 4 * q), u1 = lds4(w1 + P + 4 * q);
    const float4 u2 = lds4(w1 + 2 * P + 4 * q), bb = lds4(b1 + 4 * q);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float acc = fmaf(x0, lane(u0, k), 0.0f);
      acc = fmaf(x1, lane(u1, k), acc);
      acc = fmaf(x2, lane(u2, k), acc);
      a1[4 * q + k] = tanhf(acc + lane(bb, k));
    }
  }
  float* a1s = row + 8;
  float* d1s = a1s + P;
  store_quads<P>(a1s, a1);
  if constexpr (kTwo) {
    float a2[P];
#pragma unroll
    for (int j = 0; j < P; ++j) a2[j] = 0.0f;
#pragma unroll
    for (int i = 0; i < P; ++i) {
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const float4 u = lds4(w2 + i * P + 4 * q);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          a2[4 * q + k] = fmaf(a1[i], lane(u, k), a2[4 * q + k]);
      }
    }
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const float4 bb = lds4(b2 + 4 * q);
#pragma unroll
      for (int k = 0; k < 4; ++k) a2[4 * q + k] = tanhf(a2[4 * q + k] + lane(bb, k));
    }
    const float d_out = dv * logistic(output<P>(a2, w3, b3)) * scale;
    sts4(row, x0, x1, x2, 1.0f);
    sts4(row + 4, d_out, 1.0f, 0.0f, 0.0f);
    float* a2s = d1s + P;
    float* d2s = a2s + P;
    store_quads<P>(a2s, a2);
    // a2 becomes d2 in place.
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const float4 u = lds4(w3 + 4 * q);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float a = a2[4 * q + k];
        a2[4 * q + k] = d_out * lane(u, k) * (1.0f - a * a);
      }
    }
    store_quads<P>(d2s, a2);
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      float d[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float* wr = w2 + (4 * q + k) * P;
        float acc = 0.0f;
#pragma unroll
        for (int q2 = 0; q2 < Q; ++q2) {
          const float4 u = lds4(wr + 4 * q2);
#pragma unroll
          for (int k2 = 0; k2 < 4; ++k2)
            acc = fmaf(lane(u, k2), a2[4 * q2 + k2], acc);
        }
        const float a = a1s[4 * q + k];  // from the row: frees a1's registers
        d[k] = acc * (1.0f - a * a);
      }
      sts4(d1s + 4 * q, d[0], d[1], d[2], d[3]);
    }
  } else {
    const float d_out = dv * logistic(output<P>(a1, w3, b3)) * scale;
    sts4(row, x0, x1, x2, 1.0f);
    sts4(row + 4, d_out, 1.0f, 0.0f, 0.0f);
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const float4 u = lds4(w3 + 4 * q);
      float d[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float a = a1[4 * q + k];
        d[k] = d_out * lane(u, k) * (1.0f - a * a);
      }
      sts4(d1s + 4 * q, d[0], d[1], d[2], d[3]);
    }
  }
}

__device__ __forceinline__ void element_pass(const GradNet& g,
                                             const float* w, float x0,
                                             float x1, float x2, float dv,
                                             float scale, float* row) {
#define PFT_ELEMENT_CASE(Q)                                             \
  case Q:                                                               \
    if (g.two) element_row<Q, true>(w, x0, x1, x2, dv, scale, row);     \
    else element_row<Q, false>(w, x0, x1, x2, dv, scale, row);          \
    break;
  switch (g.q) {
    PFT_ELEMENT_CASE(1)
    PFT_ELEMENT_CASE(2)
    PFT_ELEMENT_CASE(3)
    PFT_ELEMENT_CASE(4)
    PFT_ELEMENT_CASE(5)
    PFT_ELEMENT_CASE(6)
    PFT_ELEMENT_CASE(7)
    PFT_ELEMENT_CASE(8)
  }
#undef PFT_ELEMENT_CASE
}

// Job j of a net: float offsets in the table row of its left and right
// quads (X at 0, O at 4, a1 at 8, d1 at 8 + P, a2 at 8 + 2P, d2 at 8 + 3P).
__device__ __forceinline__ void job_quads(const GradNet& g, int j, int* l,
                                          int* r) {
  const int p = 4 * g.q;
  const int a_last = g.two ? 8 + 2 * p : 8;
  if (j < g.q) {                                      // X x d1: W1, b1
    *l = 0; *r = 8 + p + 4 * j; return;
  }
  j -= g.q;
  if (g.two) {
    if (j < g.q * g.q) {                              // a1 x d2: W2
      *l = 8 + 4 * (j / g.q); *r = 8 + 3 * p + 4 * (j % g.q); return;
    }
    j -= g.q * g.q;
    if (j < g.q) {                                    // d2 x O: b2
      *l = 8 + 3 * p + 4 * j; *r = 4; return;
    }
    j -= g.q;
  }
  if (j < g.q) {                                      // a_last x O: W3
    *l = a_last + 4 * j; *r = 4; return;
  }
  *l = 4; *r = 4;                                     // O x O: b3
}

// Where the net's flat parameter j sums: job * kJobSize + entry (ii * 4 +
// jj) of the 4 x 4 outer product.  The other entries of the products are
// not parameters.
__device__ __forceinline__ int param_entry(const GradNet& g, int h1, int h2,
                                           int j) {
  if (j < kInputs * h1) {                             // W1: X row k x d1
    const int k = j / h1, c = j % h1;
    return (c / 4) * kJobSize + k * 4 + c % 4;
  }
  j -= kInputs * h1;
  if (j < h1) return (j / 4) * kJobSize + 3 * 4 + j % 4;  // b1: 1 x d1
  j -= h1;
  int job = g.q;
  if (g.two) {
    if (j < h1 * h2) {                                // W2: a1 x d2
      const int r = j / h2, c = j % h2;
      return (job + (r / 4) * g.q + c / 4) * kJobSize + (r % 4) * 4 + c % 4;
    }
    j -= h1 * h2;
    job += g.q * g.q;
    if (j < h2) return (job + j / 4) * kJobSize + (j % 4) * 4 + 1;  // b2
    j -= h2;
    job += g.q;
  }
  const int last = g.two ? h2 : h1;
  if (j < last) return (job + j / 4) * kJobSize + (j % 4) * 4;  // W3
  return (job + g.q) * kJobSize + 4;                  // b3: O[1] x O[0]
}

struct GradArgs {
  const float* mid;
  const float* inv_len;
  const float* params;
  const float* scales;
  const float* e;
  const float* a;
  const float* g_e;
  const float* g_a;
  const float* g_rho;
  const float* g_s;
  double* partial;       // (blocks, n_params)
  double* group_part;    // (groups, n_params)
  unsigned int* tickets; // groups + 1, zero between launches
  float* grad;           // (n_params,)
  int64_t n;
  Nets nets;
  float lf;
  int dim;
  int weight_floats;     // shared floats before the tables (a quad multiple)
  int group_size;
};

// Upstream gradient of field f's value at element i.
__device__ __forceinline__ float upstream(const GradArgs& a, int f,
                                          int64_t i) {
  if (f == 2) return a.g_rho[i];
  const float gs = a.g_s != nullptr ? a.g_s[i] : 0.0f;
  const float* g = f == 0 ? a.g_e : a.g_a;
  const float* other = f == 0 ? a.a : a.e;
  return (g != nullptr ? g[i] : 0.0f) + gs * other[i] * a.inv_len[i];
}

__device__ __forceinline__ bool net_on(const GradArgs& a, int f) {
  if (f == 2) return a.g_rho != nullptr;
  return (f == 0 ? a.g_e : a.g_a) != nullptr || a.g_s != nullptr;
}

__device__ __forceinline__ bool param_on(const GradArgs& a, int k) {
  return net_on(a, k >= a.nets.offset[2] ? 2 : (k >= a.nets.offset[1] ? 1 : 0));
}

// v[f] with f chosen at run time: a select, not an indexed load (which
// would copy the kernel's parameter struct to local memory).
__device__ __forceinline__ int pick(const int (&v)[kFields], int f) {
  return f == 0 ? v[0] : (f == 1 ? v[1] : v[2]);
}

constexpr int kSumCols = 4;   // epilogue: columns a thread sums at once
constexpr int kSumRows = 8;   // and rows it loads at once for each

// Sums rows [r0, r1) of the (rows, n_params) float64 matrix m in row
// order, column by column (thread t takes columns t mod kTile), with
// kSumCols x kSumRows loads in flight at a time; the sums go to dst
// (float64), or to grad (float32, zero for a skipped net's parameters).
// Inlined, like every helper that takes the kernel's parameter struct or a
// GradNet by reference: an out-of-line call would need their address and
// copy them to local memory.
__device__ __forceinline__ void sum_rows(const GradArgs& a, const double* m,
                                         int r0, int r1, double* dst,
                                         float* grad) {
  const int n_params = a.nets.n_params;
  for (int k0 = threadIdx.x; k0 < n_params; k0 += kSumCols * kTile) {
    double v[kSumCols];
#pragma unroll
    for (int c = 0; c < kSumCols; ++c) v[c] = 0.0;
    for (int r = r0; r < r1; r += kSumRows) {
      double x[kSumCols][kSumRows];
#pragma unroll
      for (int c = 0; c < kSumCols; ++c) {
        const int k = k0 + c * kTile;
#pragma unroll
        for (int j = 0; j < kSumRows; ++j)
          x[c][j] = k < n_params && r + j < r1
                        ? __ldcg(m + (int64_t)(r + j) * n_params + k) : 0.0;
      }
#pragma unroll
      for (int c = 0; c < kSumCols; ++c)
#pragma unroll
        for (int j = 0; j < kSumRows; ++j)
          if (r + j < r1) v[c] += x[c][j];
    }
#pragma unroll
    for (int c = 0; c < kSumCols; ++c) {
      const int k = k0 + c * kTile;
      if (k >= n_params) continue;
      if (dst != nullptr) dst[k] = v[c];
      else grad[k] = param_on(a, k) ? (float)v[c] : 0.0f;
    }
  }
}

__global__ void __launch_bounds__(kTile, kGradMinBlocks)
material_grad_kernel(GradArgs a) {
  extern __shared__ float4 smem4[];
  __shared__ bool s_last;
  float* w = reinterpret_cast<float*>(smem4);
  float* tab = w + a.weight_floats;
  double* sums = reinterpret_cast<double*>(tab);
  const int t = threadIdx.x;
  const int n_params = a.nets.n_params;
  // This block's elements, taken kTile at a time from e0.
  const int64_t e0 = blockIdx.x * a.n / gridDim.x;
  const int64_t e1 = (blockIdx.x + 1) * a.n / gridDim.x;

  // All three nets' weights, zero-padded, net after net: one round of
  // global loads for the block (eight in flight a thread).
  const int size0 = padded_size(grad_net(a.nets.h1[0], a.nets.h2[0]));
  const int wofs[kFields] = {
      0, size0, size0 + padded_size(grad_net(a.nets.h1[1], a.nets.h2[1]))};
  for (int i = t; i < a.weight_floats; i += kTile) w[i] = 0.0f;
  __syncthreads();
  for (int k0 = t; k0 < n_params; k0 += 8 * kTile) {
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = k0 + j * kTile;
      v[j] = k < n_params ? a.params[k] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = k0 + j * kTile;
      if (k >= n_params) continue;
      const int f = k >= a.nets.offset[2] ? 2 : (k >= a.nets.offset[1] ? 1 : 0);
      const int h1 = pick(a.nets.h1, f), h2 = pick(a.nets.h2, f);
      const int slot = padded_slot(h1, h2, grad_net(h1, h2),
                                   k - pick(a.nets.offset, f));
      w[pick(wofs, f) + slot] = v[j];
    }
  }

  for (int f = 0; f < kFields; ++f) {
    if (!net_on(a, f)) continue;
    const int h1 = pick(a.nets.h1, f), h2 = pick(a.nets.h2, f);
    const int offset = pick(a.nets.offset, f);
    const GradNet g = grad_net(h1, h2);
    const float* wf = w + pick(wofs, f);
    __syncthreads();  // the weights are in; the previous net's readers done
    const float scale = a.scales[f];
    const int job = t % g.n_jobs, slice = t / g.n_jobs;
    const bool owner = slice < g.slices;
    const int row0 = slice * kTile / g.slices;
    const int row1 = (slice + 1) * kTile / g.slices;
    int lq = 0, rq = 0;
    job_quads(g, job, &lq, &rq);
    double acc[kJobSize];
#pragma unroll
    for (int e = 0; e < kJobSize; ++e) acc[e] = 0.0;

    // The element's inputs are loaded a tile ahead: they arrive while the
    // previous tile's parameter pass runs.
    float x[kInputs] = {a.lf, 0.0f, 0.0f};
    float dv = 0.0f;
    if (e0 + t < e1) {
      load_input(a.mid, a.dim, a.lf, e0 + t, x);
      dv = upstream(a, f, e0 + t);
    }
    for (int64_t base = e0; base < e1; base += kTile) {
      // Rows past the block's last element are neither written nor read.
      const int rows = (int)min((int64_t)kTile, e1 - base);
      if (t < rows)
        element_pass(g, wf, x[0], x[1], x[2], dv, scale, tab + t * g.stride);
      __syncthreads();
      if (base + kTile + t < e1) {
        load_input(a.mid, a.dim, a.lf, base + kTile + t, x);
        dv = upstream(a, f, base + kTile + t);
      }
      if (owner) {
        float s[kJobSize];
#pragma unroll
        for (int e = 0; e < kJobSize; ++e) s[e] = 0.0f;
        const float* r = tab + row0 * g.stride;
        const int end = row1 < rows ? row1 : rows;
        for (int row = row0; row < end; ++row, r += g.stride) {
          const float4 lv = lds4(r + lq), rv = lds4(r + rq);
#pragma unroll
          for (int ii = 0; ii < 4; ++ii)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
              s[4 * ii + jj] = fmaf(lane(lv, ii), lane(rv, jj), s[4 * ii + jj]);
        }
#pragma unroll
        for (int e = 0; e < kJobSize; ++e) acc[e] += (double)s[e];
      }
      __syncthreads();
    }

    // The block's partial: the slices of each job in slice order.
    if (owner) {
#pragma unroll
      for (int e = 0; e < kJobSize; ++e)
        sums[(slice * g.n_jobs + job) * kJobSize + e] = acc[e];
    }
    __syncthreads();
    // Written parameter by parameter: coalesced stores.
    double* out = a.partial + (int64_t)blockIdx.x * n_params + offset;
    const int count = net_params(h1, h2);
    for (int j = t; j < count; j += kTile) {
      const int entry = param_entry(g, h1, h2, j);
      double v = 0.0;
      for (int s = 0; s < g.slices; ++s)
        v += sums[s * g.n_jobs * kJobSize + entry];
      out[j] = v;
    }
  }

  // Groups of group_size blocks: the last block of a group to finish sums
  // the group's partials in block order; the last group to finish sums the
  // groups in group order.
  __threadfence();
  __syncthreads();
  const int group = blockIdx.x / a.group_size;
  const int b0 = group * a.group_size;
  const int members = min(a.group_size, (int)gridDim.x - b0);
  const int n_groups = ((int)gridDim.x + a.group_size - 1) / a.group_size;
  if (t == 0)
    s_last = atomicAdd(&a.tickets[group], 1u) == (unsigned int)(members - 1);
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  sum_rows(a, a.partial, b0, b0 + members,
           a.group_part + (int64_t)group * n_params, nullptr);
  __threadfence();
  __syncthreads();
  if (t == 0) {
    a.tickets[group] = 0;  // every member has taken its ticket
    s_last = atomicAdd(&a.tickets[n_groups], 1u) == (unsigned int)(n_groups - 1);
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  sum_rows(a, a.group_part, 0, n_groups, nullptr, a.grad);
  if (t == 0) a.tickets[n_groups] = 0;
}

// Nets from the host's widths array [h1_0, h2_0, h1_1, h2_1, h1_2, h2_2];
// false when a width is out of range.
bool make_nets(const int* widths, Nets* nets) {
  int offset = 0;
  for (int f = 0; f < kFields; ++f) {
    const int h1 = widths[2 * f], h2 = widths[2 * f + 1];
    if (h1 < 1 || h1 > kMaxWidth || h2 < 0 || h2 > kMaxWidth) return false;
    nets->h1[f] = h1;
    nets->h2[f] = h2;
    nets->offset[f] = offset;
    offset += net_params(h1, h2);
  }
  nets->n_params = offset;
  return true;
}

// cudaSetDevice only when another device is current.
inline cudaError_t use_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess || current == device) return err;
  return cudaSetDevice(device);
}

}  // namespace

extern "C" {

// Number of flat parameters of nets with these widths; -1 if out of range.
int pft_material_n_params(const int* widths) {
  Nets nets;
  return make_nets(widths, &nets) ? nets.n_params : -1;
}

int pft_material_forward(int device, const float* mid, int dim,
                         const float* inv_len, float lf, int64_t n,
                         const float* params, const float* scales,
                         const int* widths, float* e, float* a, float* rho,
                         float* s, void* stream) {
  cudaError_t err = use_device(device);
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

// The backward's launch, planned once per device, widths and n
// (GradPlan in ops/kernels/material_kernel.py mirrors this layout).
struct GradPlan {
  int device, blocks, group_size, shared_bytes;
  int widths[2 * kFields];
  int64_t n;
  double* partial;         // (blocks, n_params) float64
  double* group_part;      // (ceil(blocks / group_size), n_params) float64
  unsigned int* tickets;   // ceil(blocks / group_size) + 1, zeroed once
};

static_assert(sizeof(GradPlan) == 72,
              "the ctypes mirror in material_kernel.py assumes this layout");

// Fills plan->blocks, group_size and shared_bytes for n elements on the
// device (and raises the kernel's shared-memory limit there); sizes gets
// the float64 entries of partial and group_part and the tickets' count.
int pft_material_grad_plan(GradPlan* plan, int64_t* sizes) {
  cudaError_t err = use_device(plan->device);
  if (err != cudaSuccess) return (int)err;
  Nets nets;
  if (!make_nets(plan->widths, &nets) || plan->n < 0)
    return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(material_grad_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kGradMaxShared);
  if (err != cudaSuccess) return (int)err;
  const int smem = (int)grad_shared_bytes(nets);
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, material_grad_kernel, kTile, smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                               plan->device);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int64_t tiles = (plan->n + kTile - 1) / kTile;
  const int64_t cap = (int64_t)per_sm * sms;
  const int blocks = (int)(tiles < cap ? (tiles > 0 ? tiles : 1) : cap);
  int group = 1;
  while (group * group < blocks) ++group;
  const int groups = (blocks + group - 1) / group;
  plan->blocks = blocks;
  plan->group_size = group;
  plan->shared_bytes = smem;
  sizes[0] = (int64_t)blocks * nets.n_params;
  sizes[1] = (int64_t)groups * nets.n_params;
  sizes[2] = groups + 1;
  return 0;
}

// Absent upstream gradients are null; grad: (n_params,) float32.
int pft_material_backward(const GradPlan* plan, const float* mid, int dim,
                          const float* inv_len, float lf, int64_t n,
                          const float* params, const float* scales,
                          const float* e, const float* a, const float* g_e,
                          const float* g_a, const float* g_rho,
                          const float* g_s, float* grad, void* stream) {
  cudaError_t err = use_device(plan->device);
  if (err != cudaSuccess) return (int)err;
  GradArgs args;
  if (!make_nets(plan->widths, &args.nets) || dim < 1 || dim > 2 ||
      n != plan->n)
    return (int)cudaErrorInvalidValue;
  args.mid = mid;
  args.inv_len = inv_len;
  args.params = params;
  args.scales = scales;
  args.e = e;
  args.a = a;
  args.g_e = g_e;
  args.g_a = g_a;
  args.g_rho = g_rho;
  args.g_s = g_s;
  args.partial = plan->partial;
  args.group_part = plan->group_part;
  args.tickets = plan->tickets;
  args.grad = grad;
  args.n = n;
  args.lf = lf;
  args.dim = dim;
  args.weight_floats = grad_weight_floats(args.nets);
  args.group_size = plan->group_size;
  material_grad_kernel<<<plan->blocks, kTile, plan->shared_bytes,
                         (cudaStream_t)stream>>>(args);
  return (int)cudaGetLastError();
}

}  // extern "C"
