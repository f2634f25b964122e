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
// Both kernels put all three nets' weights in shared memory once per
// block, each net zero-padded to P = 4 Q columns (Q quads: the wider
// hidden layer rounded up to 4), and run a net at an element through one
// routine, net_forward, a template on Q, the depth and the elements a
// thread: every activation has a compile-time index and stays in
// registers, and every weight is read as a float4 that all threads of a
// warp share (a broadcast), one load for four fmaf an element.  A padded
// unit's weights and bias are zero, so its activation is tanh(+0) = +0 and
// every term it adds is an exact zero: the sums are the unpadded ones.
//
// Forward (material_forward_kernel<kQuads>): bound by the issue of FP32
// instructions and by the shared-memory reads of the weights.  Per element
// the nets at widths 20/15/10 issue about 2,900 instructions: 1,600 fmaf
// (half of them inside the accurate tanhf, 96 of which take some 16
// instructions and two MUFU each) and 275 float4 weight reads, against 28
// bytes of traffic.  Nets of widths <= 20 take two elements a thread at a
// time, so each weight quad read feeds eight fmaf; wider nets take one.
// The grid's warps split the elements evenly: warp w of W takes
// [w n / W, (w + 1) n / W), 32 E at a time, lane l the elements l, l + 32,
// ...  The host's plan (material_kernel.forward_plan) sets the grid from
// the card's occupancy: a multiple of the SM count once the elements fill
// more than one block an SM, so that every SM and every warp scheduler
// gets the same work.  Loads and stores are coalesced (the midpoints as
// float2 when dim = 2), and the next elements' inputs load while the
// current ones run.  The arithmetic order is the plain version's (and
// that of the first design, one thread an element with the activations
// in local arrays): layer 1 fmaf(x0, w, 0), then x1, then x2, then + b1,
// tanhf; each layer-2 unit a chain of fmaf over i in order from 0, then
// + b2, tanhf; the output a chain over j in order, then + b3;
// softplus(o) * scale; s = (E * A) * (1 / L).
//
// Backward (material_grad_kernel): bound by arithmetic as well, about
// twice the forward's plus one multiply-add per parameter and element.
// Blocks of kTile threads; the grid is as many blocks as the card holds
// at once (occupancy x SMs, at most one per kTile elements), and block b
// takes the contiguous elements [b n / B, (b + 1) n / B), kTile at a time
// (its last tile may be short), so the blocks' loads differ by at most
// one element.  The block walks the nets one at a time; for each net:
//   * element pass: each thread takes one element of the tile, runs
//     net_forward, backpropagates in registers and writes one table row:
//     X = (lf, x, y, 1), O = (d_out, 1, 0, 0), a1, d1[, a2, d2], as
//     float4, at a row stride of an odd number of quads (the eight
//     threads of a 16-byte store phase hit distinct banks); a padded
//     unit's delta is 0;
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
constexpr int kForwardMaxThreads = 256;  // forward: the most threads a block
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

__device__ __forceinline__ void load_input(const float* __restrict__ mid,
                                           int dim, float lf, int64_t i,
                                           float* x) {
  x[0] = lf;
  x[1] = mid[i * dim];
  x[2] = dim > 1 ? mid[i * dim + 1] : 0.0f;
}

// v[f] with f chosen at run time: a select, not an indexed load (which
// would copy the kernel's parameter struct to local memory).
__device__ __forceinline__ int pick(const int (&v)[kFields], int f) {
  return f == 0 ? v[0] : (f == 1 ? v[1] : v[2]);
}

// ------------------------------------------ padded weights, shared by both

// One net's shape: both hidden layers padded to P = 4 q; the rest is the
// backward's.
struct NetShape {
  int q;        // quads of the padded width
  int two;      // two hidden layers
  int stride;   // backward table row in floats: X, O, a1, d1[, a2, d2], one pad quad
  int n_jobs;   // backward: 4 x 4 outer products of the parameter pass
  int slices;   // backward: row slices a job is cut into (slices * n_jobs <= kTile)
};

__host__ __device__ inline NetShape net_shape(int h1, int h2) {
  NetShape g;
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
__host__ __device__ inline int padded_size(const NetShape& g) {
  const int p = 4 * g.q;
  return 5 * p + 4 + (g.two ? p * p + p : 0);
}

// The same offsets at compile time, for net_forward.
template <int Q, bool kTwo>
struct Padded {
  static constexpr int P = 4 * Q;
  static constexpr int w2 = 4 * P;
  static constexpr int b2 = w2 + P * P;
  static constexpr int w3 = kTwo ? b2 + P : 4 * P;
};

// The three nets' padded weights, net after net: the first float of each
// and the total.
__host__ __device__ inline void padded_offsets(const Nets& nets,
                                               int (&wofs)[kFields]) {
  wofs[0] = 0;
  wofs[1] = padded_size(net_shape(nets.h1[0], nets.h2[0]));
  wofs[2] = wofs[1] + padded_size(net_shape(nets.h1[1], nets.h2[1]));
}

__host__ inline int padded_floats(const Nets& nets) {
  int wofs[kFields];
  padded_offsets(nets, wofs);
  return wofs[2] + padded_size(net_shape(nets.h1[2], nets.h2[2]));
}

// Position in a net's padded weights of its flat parameter j.
__device__ __forceinline__ int padded_slot(int h1, int h2, const NetShape& g,
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

// All three nets' weights, zero-padded, into w (weight_floats floats, net
// f from wofs[f]) by the block's `threads` threads, this one t: one round
// of global loads for the block (eight in flight a thread).  The caller
// synchronises before reading w.
__device__ __forceinline__ void stage_weights(float* w,
                                              const float* __restrict__ params,
                                              const Nets& nets,
                                              const int (&wofs)[kFields],
                                              int weight_floats, int t,
                                              int threads) {
  const int n_params = nets.n_params;
  for (int i = t; i < weight_floats; i += threads) w[i] = 0.0f;
  __syncthreads();
  for (int k0 = t; k0 < n_params; k0 += 8 * threads) {
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = k0 + j * threads;
      v[j] = k < n_params ? params[k] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = k0 + j * threads;
      if (k >= n_params) continue;
      const int f = k >= nets.offset[2] ? 2 : (k >= nets.offset[1] ? 1 : 0);
      const int h1 = pick(nets.h1, f), h2 = pick(nets.h2, f);
      const int slot = padded_slot(h1, h2, net_shape(h1, h2),
                                   k - pick(nets.offset, f));
      w[pick(wofs, f) + slot] = v[j];
    }
  }
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

// ------------------------------------------------------- one net's forward

// Layer 1 at E elements: a1[e][j] = tanhf(fmaf(x2, W1[2][j],
// fmaf(x1, W1[1][j], fmaf(x0, W1[0][j], 0))) + b1[j]).
template <int Q, int E>
__device__ __forceinline__ void hidden1(const float* __restrict__ w, float x0,
                                        const float (&x1)[E],
                                        const float (&x2)[E],
                                        float (&a1)[E][4 * Q]) {
  constexpr int P = 4 * Q;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const float4 u0 = lds4(w + 4 * q), u1 = lds4(w + P + 4 * q);
    const float4 u2 = lds4(w + 2 * P + 4 * q), bb = lds4(w + 3 * P + 4 * q);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float t0 = fmaf(x0, lane(u0, k), 0.0f);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float acc = fmaf(x2[e], lane(u2, k),
                               fmaf(x1[e], lane(u1, k), t0));
        a1[e][4 * q + k] = tanhf(acc + lane(bb, k));
      }
    }
  }
}

// Layer 2 at E elements: a2[e][j] = tanhf(sum_i a1[e][i] W2[i][j] + b2[j]),
// each sum a chain of fmaf over i in order from 0.  A float4 of W2 feeds
// 4 E fmaf.
template <int Q, int E>
__device__ __forceinline__ void hidden2(const float* __restrict__ w2,
                                        const float* __restrict__ b2,
                                        const float (&a1)[E][4 * Q],
                                        float (&a2)[E][4 * Q]) {
  constexpr int P = 4 * Q;
#pragma unroll
  for (int e = 0; e < E; ++e)
#pragma unroll
    for (int j = 0; j < P; ++j) a2[e][j] = 0.0f;
#pragma unroll
  for (int i = 0; i < P; ++i) {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const float4 u = lds4(w2 + i * P + 4 * q);
#pragma unroll
      for (int e = 0; e < E; ++e)
#pragma unroll
        for (int k = 0; k < 4; ++k)
          a2[e][4 * q + k] = fmaf(a1[e][i], lane(u, k), a2[e][4 * q + k]);
    }
  }
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const float4 bb = lds4(b2 + 4 * q);
#pragma unroll
    for (int e = 0; e < E; ++e)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        a2[e][4 * q + k] = tanhf(a2[e][4 * q + k] + lane(bb, k));
  }
}

// The raw output at E elements: sum_j h[e][j] W3[j], a chain over j in
// order from 0, then + b3 (the float after W3's P).
template <int Q, int E>
__device__ __forceinline__ void output(const float (&h)[E][4 * Q],
                                       const float* __restrict__ w3,
                                       float (&o)[E]) {
  float acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.0f;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const float4 u = lds4(w3 + 4 * q);
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int e = 0; e < E; ++e)
        acc[e] = fmaf(h[e][4 * q + k], lane(u, k), acc[e]);
  }
  const float b3 = w3[4 * Q];
#pragma unroll
  for (int e = 0; e < E; ++e) o[e] = acc[e] + b3;
}

// One net's raw output o at E elements, inputs (x0, x1[e], x2[e]); the
// hidden activations are left in a1 and (two hidden layers) a2.  w: the
// net's padded weights in shared memory.
template <int Q, bool kTwo, int E>
__device__ __forceinline__ void net_forward(const float* __restrict__ w,
                                            float x0, const float (&x1)[E],
                                            const float (&x2)[E],
                                            float (&a1)[E][4 * Q],
                                            float (&a2)[E][4 * Q],
                                            float (&o)[E]) {
  using L = Padded<Q, kTwo>;
  hidden1<Q, E>(w, x0, x1, x2, a1);
  if constexpr (kTwo) {
    hidden2<Q, E>(w + L::w2, w + L::b2, a1, a2);
    output<Q, E>(a2, w + L::w3, o);
  } else {
    output<Q, E>(a1, w + L::w3, o);
  }
}

// ------------------------------------------------------------ forward

struct ForwardArgs {
  const float* mid;
  const float* inv_len;
  const float* params;
  const float* scales;
  float* e;
  float* a;
  float* rho;
  float* s;
  int64_t n;
  Nets nets;
  float lf;
  int dim;
  int mid_float2;     // dim 2 and mid 8-byte aligned: one float2 an element
  int weight_floats;
};

// Element i's (x, y) and 1 / L; zeros when i is past the warp's end.
__device__ __forceinline__ void forward_inputs(const ForwardArgs& a,
                                               int64_t i, int64_t end,
                                               float& x, float& y,
                                               float& inv_len) {
  x = y = inv_len = 0.0f;
  if (i >= end) return;
  if (a.mid_float2) {
    const float2 m = __ldg(reinterpret_cast<const float2*>(a.mid) + i);
    x = m.x;
    y = m.y;
  } else {
    x = __ldg(a.mid + i * a.dim);
    if (a.dim > 1) y = __ldg(a.mid + i * a.dim + 1);
  }
  inv_len = __ldg(a.inv_len + i);
}

// One net's raw output at E elements, the template chosen by its shape
// (nets wider than kQuads quads do not reach a kernel compiled for
// kQuads).
template <int E, int kQuads>
__device__ __forceinline__ void net_output(const NetShape& g, const float* w,
                                           float x0, const float (&x1)[E],
                                           const float (&x2)[E],
                                           float (&o)[E]) {
#define PFT_FORWARD_CASE(Q)                                             \
  case Q:                                                               \
    if constexpr (Q <= kQuads) {                                        \
      float a1[E][4 * Q], a2[E][4 * Q];                                 \
      if (g.two) net_forward<Q, true, E>(w, x0, x1, x2, a1, a2, o);     \
      else net_forward<Q, false, E>(w, x0, x1, x2, a1, a2, o);          \
    }                                                                   \
    break;
  switch (g.q) {
    PFT_FORWARD_CASE(1)
    PFT_FORWARD_CASE(2)
    PFT_FORWARD_CASE(3)
    PFT_FORWARD_CASE(4)
    PFT_FORWARD_CASE(5)
    PFT_FORWARD_CASE(6)
    PFT_FORWARD_CASE(7)
    PFT_FORWARD_CASE(8)
  }
#undef PFT_FORWARD_CASE
}

// The forward is compiled for nets of at most kNarrowQuads quads (widths
// <= 20: every net of the corpus and the PINN grid) and for the widest
// (32): a kernel's registers follow its widest template.  Narrow nets take
// two elements a thread (each weight quad feeds eight fmaf, half the
// shared-memory reads an element of one), wide ones one (two would need
// 191 registers).  Either way at most 128 registers a thread (more
// registers cut the warps an SM and ran slower; fewer spilled).
constexpr int kNarrowQuads = 5;
constexpr int kWideQuads = kMaxWidth / 4;

__host__ __device__ constexpr int forward_elements(int quads) {
  return quads <= kNarrowQuads ? 2 : 1;
}
__host__ __device__ constexpr int forward_max_threads(int quads) {
  return forward_elements(quads) == 2 ? kForwardMaxThreads : 128;
}
__host__ __device__ constexpr int forward_min_blocks(int quads) {
  return 65536 / 128 / forward_max_threads(quads);
}

// forward_elements(kQuads) elements a thread at a time; blockDim.x a
// multiple of 32, at most forward_max_threads(kQuads); every net at most
// kQuads quads.
template <int kQuads>
__global__ void __launch_bounds__(forward_max_threads(kQuads),
                                  forward_min_blocks(kQuads))
material_forward_kernel(ForwardArgs a) {
  constexpr int E = forward_elements(kQuads);
  extern __shared__ float4 smem4[];
  float* w = reinterpret_cast<float*>(smem4);
  constexpr int kStep = 32 * E;
  const int lane_id = threadIdx.x & 31;
  const int64_t warps = (int64_t)gridDim.x * (blockDim.x >> 5);
  const int64_t warp =
      (int64_t)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int64_t e0 = warp * a.n / warps;
  const int64_t e1 = (warp + 1) * a.n / warps;

  // The first elements' inputs load while the weights are staged.
  float x1[E], x2[E], il[E];
#pragma unroll
  for (int e = 0; e < E; ++e)
    forward_inputs(a, e0 + lane_id + 32 * e, e1, x1[e], x2[e], il[e]);
  int wofs[kFields];
  padded_offsets(a.nets, wofs);
  stage_weights(w, a.params, a.nets, wofs, a.weight_floats, threadIdx.x,
                blockDim.x);
  const float scale0 = a.scales[0], scale1 = a.scales[1];
  const float scale2 = a.scales[2];
  __syncthreads();

  for (int64_t base = e0; base < e1; base += kStep) {
    float nx1[E], nx2[E], nil[E];
#pragma unroll
    for (int e = 0; e < E; ++e)
      forward_inputs(a, base + kStep + lane_id + 32 * e, e1, nx1[e], nx2[e],
                     nil[e]);
    float ve[E], va[E];
#pragma unroll 1
    for (int f = 0; f < kFields; ++f) {
      float o[E];
      net_output<E, kQuads>(
          net_shape(pick(a.nets.h1, f), pick(a.nets.h2, f)),
          w + pick(wofs, f), a.lf, x1, x2, o);
      const float scale = f == 0 ? scale0 : (f == 1 ? scale1 : scale2);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float v = softplus(o[e]) * scale;
        const int64_t i = base + lane_id + 32 * e;
        if (f == 0) ve[e] = v;
        else if (f == 1) va[e] = v;
        else if (i < e1) a.rho[i] = v;
      }
    }
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int64_t i = base + lane_id + 32 * e;
      if (i < e1) {
        a.e[i] = ve[e];
        a.a[i] = va[e];
        a.s[i] = ve[e] * va[e] * il[e];
      }
      x1[e] = nx1[e];
      x2[e] = nx2[e];
      il[e] = nil[e];
    }
  }
}

// The widest net's quads.
inline int widest_quads(const Nets& nets) {
  int quads = 0;
  for (int f = 0; f < kFields; ++f) {
    const int q = net_shape(nets.h1[f], nets.h2[f]).q;
    quads = q > quads ? q : quads;
  }
  return quads;
}

// The forward kernel for these nets.
using ForwardKernel = void (*)(ForwardArgs);

ForwardKernel forward_kernel(const Nets& nets) {
  return widest_quads(nets) <= kNarrowQuads
             ? material_forward_kernel<kNarrowQuads>
             : material_forward_kernel<kWideQuads>;
}

// A launch form the kernel for these nets takes: its elements a thread
// and a multiple of 32 threads a block, at most its largest block.
inline bool forward_form_ok(const Nets& nets, int per_thread, int threads) {
  const int quads = widest_quads(nets) <= kNarrowQuads ? kNarrowQuads
                                                       : kWideQuads;
  return per_thread == forward_elements(quads) && threads >= 32 &&
         threads <= forward_max_threads(quads) && threads % 32 == 0;
}

// ------------------------------------------------------------ backward

// Shared memory of the backward: the three nets' padded weights, net
// after net, then the tables of kTile rows (reused as the float64 slice
// sums).
__host__ inline size_t grad_shared_bytes(const Nets& nets) {
  int stride = 0;
  for (int f = 0; f < kFields; ++f) {
    const int s = net_shape(nets.h1[f], nets.h2[f]).stride;
    stride = s > stride ? s : stride;
  }
  const size_t tables = sizeof(float) * kTile * stride;
  const size_t slices = sizeof(double) * kTile * kJobSize;
  return sizeof(float) * padded_floats(nets)
         + (tables > slices ? tables : slices);
}

// The largest shared memory any widths need (32 wide, two layers).
constexpr size_t kGradMaxShared =
    sizeof(float) * kFields * (6 * 32 + 4 + 32 * 32)
    + sizeof(float) * kTile * 4 * (3 + 4 * 8);

// Element pass of one net for one element: net_forward, the deltas in
// registers, then the element's table row.  w: the padded weights.
template <int Q, bool kTwo>
__device__ __forceinline__ void element_row(const float* __restrict__ w,
                                            float x0, float x1, float x2,
                                            float dv, float scale,
                                            float* __restrict__ row) {
  constexpr int P = 4 * Q;
  using L = Padded<Q, kTwo>;
  const float* w2 = w + L::w2;
  const float* w3 = w + L::w3;
  const float xs1[1] = {x1}, xs2[1] = {x2};
  float a1[1][P], a2[1][P], o[1];
  net_forward<Q, kTwo, 1>(w, x0, xs1, xs2, a1, a2, o);
  const float d_out = dv * logistic(o[0]) * scale;
  float* a1s = row + 8;
  float* d1s = a1s + P;
  sts4(row, x0, x1, x2, 1.0f);
  sts4(row + 4, d_out, 1.0f, 0.0f, 0.0f);
  store_quads<P>(a1s, a1[0]);
  if constexpr (kTwo) {
    float (&h)[P] = a2[0];
    float* a2s = d1s + P;
    float* d2s = a2s + P;
    store_quads<P>(a2s, h);
    // a2 becomes d2 in place.
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const float4 u = lds4(w3 + 4 * q);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float a = h[4 * q + k];
        h[4 * q + k] = d_out * lane(u, k) * (1.0f - a * a);
      }
    }
    store_quads<P>(d2s, h);
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
            acc = fmaf(lane(u, k2), h[4 * q2 + k2], acc);
        }
        const float a = a1s[4 * q + k];  // from the row: frees a1's registers
        d[k] = acc * (1.0f - a * a);
      }
      sts4(d1s + 4 * q, d[0], d[1], d[2], d[3]);
    }
  } else {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const float4 u = lds4(w3 + 4 * q);
      float d[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float a = a1[0][4 * q + k];
        d[k] = d_out * lane(u, k) * (1.0f - a * a);
      }
      sts4(d1s + 4 * q, d[0], d[1], d[2], d[3]);
    }
  }
}

__device__ __forceinline__ void element_pass(const NetShape& g,
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
__device__ __forceinline__ void job_quads(const NetShape& g, int j, int* l,
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
__device__ __forceinline__ int param_entry(const NetShape& g, int h1, int h2,
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

constexpr int kSumCols = 4;   // epilogue: columns a thread sums at once
constexpr int kSumRows = 8;   // and rows it loads at once for each

// Sums rows [r0, r1) of the (rows, n_params) float64 matrix m in row
// order, column by column (thread t takes columns t mod kTile), with
// kSumCols x kSumRows loads in flight at a time; the sums go to dst
// (float64), or to grad (float32, zero for a skipped net's parameters).
// Inlined, like every helper that takes the kernel's parameter struct or a
// NetShape by reference: an out-of-line call would need their address and
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

  int wofs[kFields];
  padded_offsets(a.nets, wofs);
  stage_weights(w, a.params, a.nets, wofs, a.weight_floats, t, kTile);

  for (int f = 0; f < kFields; ++f) {
    if (!net_on(a, f)) continue;
    const int h1 = pick(a.nets.h1, f), h2 = pick(a.nets.h2, f);
    const int offset = pick(a.nets.offset, f);
    const NetShape g = net_shape(h1, h2);
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

// For the forward at these widths, taking per_thread elements a thread in
// blocks of `threads`: out[0] the blocks one SM holds, out[1] the SMs,
// out[2] the kernel's registers a thread, out[3] its local-memory bytes a
// thread (spills).
int pft_material_forward_occupancy(int device, int per_thread, int threads,
                                   const int* widths, int* out) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  Nets nets;
  if (!make_nets(widths, &nets) ||
      !forward_form_ok(nets, per_thread, threads))
    return (int)cudaErrorInvalidValue;
  const void* fn = (const void*)forward_kernel(nets);
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, fn, threads, sizeof(float) * padded_floats(nets));
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  out[0] = per_sm;
  out[1] = sms;
  out[2] = attr.numRegs;
  out[3] = (int)attr.localSizeBytes;
  return 0;
}

// (E, A, rho, s) at n elements in `blocks` blocks of `threads` threads,
// per_thread elements a thread at a time (material_kernel.forward_plan).
int pft_material_forward(int device, const float* mid, int dim,
                         const float* inv_len, float lf, int64_t n,
                         const float* params, const float* scales,
                         const int* widths, int per_thread, int threads,
                         int blocks, float* e, float* a, float* rho,
                         float* s, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  ForwardArgs args;
  if (!make_nets(widths, &args.nets) || dim < 1 || dim > 2 || n < 0 ||
      !forward_form_ok(args.nets, per_thread, threads) || blocks < 1)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  args.mid = mid;
  args.inv_len = inv_len;
  args.params = params;
  args.scales = scales;
  args.e = e;
  args.a = a;
  args.rho = rho;
  args.s = s;
  args.n = n;
  args.lf = lf;
  args.dim = dim;
  args.mid_float2 = dim == 2 && reinterpret_cast<uintptr_t>(mid) % 8 == 0;
  args.weight_floats = padded_floats(args.nets);
  void* launch_args[] = {&args};
  err = cudaLaunchKernel((const void*)forward_kernel(args.nets),
                         dim3(blocks), dim3(threads), launch_args,
                         sizeof(float) * args.weight_floats,
                         (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
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
  args.weight_floats = padded_floats(args.nets);
  args.group_size = plan->group_size;
  material_grad_kernel<<<plan->blocks, kTile, plan->shared_bytes,
                         (cudaStream_t)stream>>>(args);
  return (int)cudaGetLastError();
}

}  // extern "C"
