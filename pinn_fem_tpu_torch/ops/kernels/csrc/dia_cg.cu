// Banded (DIA) stencil and fused Jacobi-PCG kernels for Hopper (sm_90a).
//
//   pft_dia_matvec      y[i] = sum_k d[k, i] * u[i + off_k]
//       replaces pinn_fem_tpu/ops/pallas/dia_kernel.py:_dia_kernel
//   pft_dia_dir_matvec  p_new = z + beta * p ; ap = mask * (K p_new) ;
//                       per-block sum(p_new * ap)
//       replaces pinn_fem_tpu/ops/pallas/cg_kernel.py:_dir_matvec_kernel
//   pft_cg_update       alpha = rz / pAp ; x += alpha p ; r -= alpha ap ;
//                       z = inv_diag * r ; then, in the last block, the
//                       scalar tail of the PCG iteration (beta, rz, rn2,
//                       the iteration count and the stop test)
//       replaces pinn_fem_tpu/ops/pallas/cg_kernel.py:_update_kernel and
//       the scalar recurrence of its while_loop body
//
// Layout: the diagonals stay (nd, ndof) row-major (nd may be as large as
// 192, so nothing is unrolled by a fixed count).
//
// What bounds them on this card: memory.  Each output row costs nd + 2
// floats of traffic in the matvec, nd + 5 in the direction kernel and 8 in
// the update, against one multiply-add per diagonal, far below the point
// where arithmetic would matter.  At the sizes of the Newton path (40k
// rows) a launch is a few microseconds, so latency and the host's launch
// cost count as much as bandwidth.
//
// The stencil (stencil_kernel).  A block owns a tile of consecutive rows
// and first copies the window u[tile - halo_lo, tile + halo_hi) into
// shared memory with cp.async (16-byte chunks where the address allows,
// 4-byte copies at a misaligned or ragged edge, zeros outside [0, ndof)),
// together with the offsets as int32 relative to the window.  Each thread
// then owns four consecutive rows: it reads each diagonal as one float4
// (two float2 or four floats where the row of that diagonal is not 16-byte
// aligned, which depends on k only, so the branch is uniform) and the
// window with no bounds test.  This is the VMEM window of the TPU kernel.
// A band whose window does not fit in shared memory takes the second path
// of the same kernel, which reads u from global memory with bounds tests.
// The host's plan (ops/kernels/dia_kernel.stencil_plan) picks the tile.
//
// The direction kernel (dia_dir_matvec_kernel) is built the same way.  A
// block stages the z and p windows of its tile with cp.async, forms
// p_new = z + beta p once per window element in shared memory (a separate
// multiply and add) and writes the tile's own rows of it to p_out; each
// thread then owns R consecutive rows of each pass (R = 1, 2 or 4, a
// template parameter, with the block size), reads the diagonals and the
// mask R at a time (float4 / float2 where aligned) and the window with no
// bounds test.  Each thread sums its own rows' p_new * ap in row order and
// the block sums its threads by block_tree: one float32 partial a block.
// The host's plan (ops/kernels/dia_kernel.direction_plan) picks R, the
// block size and the tile so that small systems (the 40k-DOF Newton grid)
// still keep about 8 warps on every SM, and large ones read four rows a
// thread.  A band too wide for two windows takes the same kernel's second
// path: p_new at a neighbour is rebuilt from z and p in global memory.
//
// The update (cg_update_kernel) runs a fixed grid of kUpdateBlocks blocks
// walking the rows four at a time (float4).  Each block sums the direction
// kernel's partials itself in one fixed order, so every block computes
// the same alpha.  Block partials of r.z and r.r (accumulated in double)
// go to a buffer; the last block to arrive (a ticket taken after
// __threadfence) sums them in index order and finishes the iteration on
// the device, writing the stop flag that the next direction kernel reads.
// One PCG iteration is two launches and no host work besides them.
//
// Numerics: built with --fmad=false, so `acc + d * v` rounds the product
// and the sum separately, exactly as the plain PyTorch versions do with
// separate multiply and add operations.  The diagonals are summed in order
// k = 0..nd-1, and every reduction is a fixed tree (no float atomics), so
// each kernel is bit-identical to its plain twin and runs repeat bit for
// bit.  The twins in ops/kernels/*.py spell out the same orders.
//
// Early exit: the two CG kernels take a device stop flag (one byte).  When
// it is set they return without writing, which freezes the solver state
// while the host polls the flag only every few iterations.
//
// Each entry point selects the device when it is not the current one,
// launches on the given stream and returns cudaGetLastError() as an int
// (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // power of two: the tree reductions need it
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerThread = 4;
constexpr int kUpdateBlocks = 264;  // 2 x 132 SMs, fixed: the twin's partition
constexpr int kMaxSharedBytes = 232448;  // 227 KB, the most a block may ask
constexpr float kTiny = 1e-30f;

// The fused PCG loop's device state (32 bytes; the layout of STATE_* in
// ops/kernels/cg_kernel.py).
struct PcgState {
  float beta, rz, rn2, tol_b;
  int it, live;
  unsigned char stop, pad[3];
  unsigned int ticket;
};
static_assert(sizeof(PcgState) == 32, "PcgState is 32 bytes");

// ---------------------------------------------------------------- stencil

__device__ __forceinline__ void cp_async_16(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_4(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// d[0..3] by the widest load the address allows.
__device__ __forceinline__ void load4(const float* __restrict__ d,
                                      float* v) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(d);
  if ((a & 15) == 0) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(d));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else if ((a & 7) == 0) {
    const float2 lo = __ldg(reinterpret_cast<const float2*>(d));
    const float2 hi = __ldg(reinterpret_cast<const float2*>(d + 2));
    v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
  } else {
    for (int e = 0; e < 4; ++e) v[e] = __ldg(d + e);
  }
}

// Rows [t0, t0 + tile) of one block, tile = kRowsPerThread * blockDim.x *
// passes.  offsets[k] is off_k + halo_lo on the staged path, off_k on the
// wide one; window = tile + halo_lo + halo_hi floats (staged path only).
__global__ void __launch_bounds__(kThreads)
stencil_kernel(const float* __restrict__ diags, const int* __restrict__ offsets,
               int nd, int64_t ndof, const float* __restrict__ u,
               float* __restrict__ y, int tile, int halo_lo, int window,
               int staged) {
  extern __shared__ float4 smem4[];
  float* win = reinterpret_cast<float*>(smem4);
  int* soff = reinterpret_cast<int*>(win + (staged ? window : 0));
  const int64_t t0 = (int64_t)blockIdx.x * tile;
  for (int k = threadIdx.x; k < nd; k += blockDim.x) soff[k] = offsets[k];
  if (staged) {
    // tile and halo_lo are multiples of 4, so every chunk starts at a
    // multiple of 4 and is 16-byte aligned when u is.
    const int64_t ws = t0 - halo_lo;
    const bool aligned = (reinterpret_cast<uintptr_t>(u) & 15) == 0;
    for (int c = threadIdx.x; c < window / 4; c += blockDim.x) {
      const int64_t g = ws + 4 * (int64_t)c;
      float* dst = win + 4 * c;
      if (aligned && g >= 0 && g + 4 <= ndof) {
        cp_async_16(dst, u + g);
      } else {
        for (int e = 0; e < 4; ++e) {
          if (g + e >= 0 && g + e < ndof) {
            cp_async_4(dst + e, u + g + e);
          } else {
            dst[e] = 0.0f;
          }
        }
      }
    }
    cp_async_wait_all();
  }
  __syncthreads();
  const bool y_aligned = (reinterpret_cast<uintptr_t>(y) & 15) == 0;
  for (int li = kRowsPerThread * threadIdx.x; li < tile;
       li += kRowsPerThread * blockDim.x) {
    const int64_t i0 = t0 + li;
    if (i0 >= ndof) break;
    const bool full = i0 + kRowsPerThread <= ndof;
    float acc[kRowsPerThread] = {0.0f, 0.0f, 0.0f, 0.0f};
    // Unrolled so that several diagonals' loads are in flight at once;
    // the sums still go in order k = 0..nd-1.
#pragma unroll 4
    for (int k = 0; k < nd; ++k) {
      const float* d = diags + (int64_t)k * ndof + i0;
      float dv[kRowsPerThread], uv[kRowsPerThread];
      if (full) {
        load4(d, dv);
      } else {
        for (int e = 0; e < kRowsPerThread; ++e)
          dv[e] = i0 + e < ndof ? __ldg(d + e) : 0.0f;
      }
      const int o = soff[k];
      if (staged) {
        for (int e = 0; e < kRowsPerThread; ++e) uv[e] = win[li + o + e];
      } else {
        for (int e = 0; e < kRowsPerThread; ++e) {
          const int64_t j = i0 + e + o;
          uv[e] = (j >= 0 && j < ndof) ? __ldg(u + j) : 0.0f;
        }
      }
      for (int e = 0; e < kRowsPerThread; ++e) acc[e] = acc[e] + dv[e] * uv[e];
    }
    if (full && y_aligned) {
      *reinterpret_cast<float4*>(y + i0) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
    } else {
      for (int e = 0; e < kRowsPerThread; ++e)
        if (i0 + e < ndof) y[i0 + e] = acc[e];
    }
  }
}

// -------------------------------------------------------------- direction

// Block sum of one value per thread over W warps: a shuffle tree inside
// each warp (lane l takes lane l + s, s = 16..1), then the same tree over
// the warps' sums.  Every thread calls it; thread 0 holds the result.
template <typename T, int W = kWarps>
__device__ __forceinline__ T block_tree(T v, T* warp_buf) {
  for (int s = 16; s > 0; s >>= 1) v = v + __shfl_down_sync(0xffffffffu, v, s);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // warp_buf may still be read by an earlier call
  if (lane == 0) warp_buf[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < W ? warp_buf[lane] : T(0);
    for (int s = W / 2; s > 0; s >>= 1)
      v = v + __shfl_down_sync(0xffffffffu, v, s);
  }
  return v;
}

// d[0..R) by the widest load the address allows (R = 1, 2 or 4).
template <int R>
__device__ __forceinline__ void load_rows(const float* __restrict__ d,
                                          float* v) {
  if (R == 4) {
    load4(d, v);
  } else if (R == 2 && (reinterpret_cast<uintptr_t>(d) & 7) == 0) {
    const float2 q = __ldg(reinterpret_cast<const float2*>(d));
    v[0] = q.x; v[1] = q.y;
  } else {
    for (int e = 0; e < R; ++e) v[e] = __ldg(d + e);
  }
}

// y[0..R) = v, as one float4 / float2 store where `aligned` (y's base is
// 4R-byte aligned and every row index is a multiple of R).
template <int R>
__device__ __forceinline__ void store_rows(float* __restrict__ y,
                                           const float* v, bool aligned) {
  if (R == 4 && aligned) {
    *reinterpret_cast<float4*>(y) = make_float4(v[0], v[1], v[2], v[3]);
  } else if (R == 2 && aligned) {
    *reinterpret_cast<float2*>(y) = make_float2(v[0], v[1]);
  } else {
    for (int e = 0; e < R; ++e) y[e] = v[e];
  }
}

// Copy src[ws, ws + window) to win with cp.async, 16-byte chunks where
// src is 16-byte aligned and the chunk lies inside [0, ndof), 4-byte
// copies at a ragged edge; entries outside [0, ndof) are not copied (the
// caller never reads them).  ws and window are multiples of 4.
__device__ __forceinline__ void stage_window(float* win,
                                             const float* __restrict__ src,
                                             int64_t ws, int window,
                                             int64_t ndof) {
  const bool aligned = (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  for (int c = threadIdx.x; c < window / 4; c += blockDim.x) {
    const int64_t g = ws + 4 * (int64_t)c;
    if (aligned && g >= 0 && g + 4 <= ndof) {
      cp_async_16(win + 4 * c, src + g);
    } else {
      for (int e = 0; e < 4; ++e)
        if (g + e >= 0 && g + e < ndof) cp_async_4(win + 4 * c + e, src + g + e);
    }
  }
}

// Rows [t0, t0 + tile) of one block, tile = R * T * passes; thread t owns
// rows t0 + R t + j R T + e (e < R) of pass j.  offsets[k] is off_k +
// halo_lo on the staged path, off_k on the wide one; window = tile +
// halo_lo + halo_hi floats (staged path only).
//
// Staged: the block copies the z and p windows into shared memory, then
// forms p_new = z + beta p once per window element into the first (zero
// outside [0, ndof), as the plain version pads it) and writes the tile's
// own rows of it to p_out.  Each row then reads p_new at its neighbours
// from the window.  Wide: the neighbours' p_new is rebuilt from z and p
// in global memory, with bounds tests.  Either way a thread sums its own
// rows' p_new * ap in row order, and block_tree sums the threads.
template <int R, int T>
__global__ void __launch_bounds__(T)
dia_dir_matvec_kernel(const float* __restrict__ beta_ptr,
                  const float* __restrict__ z, const float* __restrict__ p,
                  const float* __restrict__ diags,
                  const int* __restrict__ offsets, int nd, int64_t ndof,
                  const float* __restrict__ mask, float* __restrict__ p_out,
                  float* __restrict__ ap_out, float* __restrict__ partial,
                  const unsigned char* __restrict__ stop, int tile,
                  int halo_lo, int window, int staged) {
  extern __shared__ float4 smem4[];
  __shared__ float warp_buf[T / 32];
  float* pw = reinterpret_cast<float*>(smem4);      // z, then p_new
  float* qw = pw + (staged ? window : 0);           // p
  int* soff = reinterpret_cast<int*>(qw + (staged ? window : 0));
  const int64_t t0 = (int64_t)blockIdx.x * tile;
  const int64_t ws = t0 - halo_lo;
  // Every copy into shared memory is in flight before the one wait: the
  // offsets and, staged, the z and p windows; the stop flag and beta are
  // read meanwhile.
  for (int k = threadIdx.x; k < nd; k += T)
    cp_async_4(reinterpret_cast<float*>(soff + k),
               reinterpret_cast<const float*>(offsets + k));
  if (staged) {
    stage_window(pw, z, ws, window, ndof);
    stage_window(qw, p, ws, window, ndof);
  }
  const bool stopped = stop != nullptr && __ldg(stop);
  const float beta = __ldg(beta_ptr);
  cp_async_wait_all();
  if (stopped) return;  // uniform over the grid: nothing is written
  __syncthreads();
  if (staged) {
    const bool out4 = (reinterpret_cast<uintptr_t>(p_out) & 15) == 0;
    for (int c = threadIdx.x; c < window / 4; c += T) {
      const int64_t g = ws + 4 * (int64_t)c;
      const float4 zv = reinterpret_cast<const float4*>(pw)[c];
      const float4 pv = reinterpret_cast<const float4*>(qw)[c];
      const float zs[4] = {zv.x, zv.y, zv.z, zv.w};
      const float ps[4] = {pv.x, pv.y, pv.z, pv.w};
      float v[4];
      for (int e = 0; e < 4; ++e)
        v[e] = (g + e >= 0 && g + e < ndof) ? zs[e] + beta * ps[e] : 0.0f;
      reinterpret_cast<float4*>(pw)[c] = make_float4(v[0], v[1], v[2], v[3]);
      const int li = 4 * c - halo_lo;  // a multiple of 4
      if (li >= 0 && li < tile) {
        if (out4 && g + 4 <= ndof) {
          *reinterpret_cast<float4*>(p_out + g) =
              make_float4(v[0], v[1], v[2], v[3]);
        } else {
          for (int e = 0; e < 4; ++e)
            if (g + e < ndof) p_out[g + e] = v[e];
        }
      }
    }
  }
  __syncthreads();
  const bool ap_vec =
      (reinterpret_cast<uintptr_t>(ap_out) & (4 * R - 1)) == 0;
  const bool p_vec = (reinterpret_cast<uintptr_t>(p_out) & (4 * R - 1)) == 0;
  float sum = 0.0f;
  for (int li = R * threadIdx.x; li < tile; li += R * T) {
    const int64_t i0 = t0 + li;
    if (i0 >= ndof) break;
    const bool full = i0 + R <= ndof;
    float acc[R];
    for (int e = 0; e < R; ++e) acc[e] = 0.0f;
    // Unrolled so that several diagonals' loads are in flight at once;
    // the sums still go in order k = 0..nd-1.
#pragma unroll 4
    for (int k = 0; k < nd; ++k) {
      const float* d = diags + (int64_t)k * ndof + i0;
      float dv[R], uv[R];
      if (full) {
        load_rows<R>(d, dv);
      } else {
        for (int e = 0; e < R; ++e) dv[e] = i0 + e < ndof ? __ldg(d + e) : 0.0f;
      }
      const int o = soff[k];
      if (staged) {
        for (int e = 0; e < R; ++e) uv[e] = pw[li + o + e];
      } else {
        for (int e = 0; e < R; ++e) {
          const int64_t j = i0 + e + o;
          uv[e] = (j >= 0 && j < ndof) ? __ldg(z + j) + beta * __ldg(p + j)
                                       : 0.0f;
        }
      }
      for (int e = 0; e < R; ++e) acc[e] = acc[e] + dv[e] * uv[e];
    }
    float mv[R], pn[R], ap[R];
    if (full) {
      load_rows<R>(mask + i0, mv);
    } else {
      for (int e = 0; e < R; ++e) mv[e] = i0 + e < ndof ? __ldg(mask + i0 + e) : 0.0f;
    }
    for (int e = 0; e < R; ++e) {
      pn[e] = staged ? pw[halo_lo + li + e]
                     : (i0 + e < ndof ? __ldg(z + i0 + e) + beta * __ldg(p + i0 + e)
                                      : 0.0f);
      ap[e] = acc[e] * mv[e];
    }
    if (full) {
      store_rows<R>(ap_out + i0, ap, ap_vec);
      if (!staged) store_rows<R>(p_out + i0, pn, p_vec);
    } else {
      for (int e = 0; e < R; ++e) {
        if (i0 + e < ndof) {
          ap_out[i0 + e] = ap[e];
          if (!staged) p_out[i0 + e] = pn[e];
        }
      }
    }
    for (int e = 0; e < R; ++e)
      if (i0 + e < ndof) sum = sum + pn[e] * ap[e];
  }
  sum = block_tree<float, T / 32>(sum, warp_buf);
  if (threadIdx.x == 0) partial[blockIdx.x] = sum;
}

// ----------------------------------------------------------------- update

// Sum of parts[0], parts[stride], ... (m entries) in one fixed order:
// thread t adds entries t, t + kThreads, ... in turn, then block_tree.
// The loads are unrolled so that several are in flight at once (the sums
// still go in order).
template <typename T, typename Ptr>
__device__ __forceinline__ T fixed_sum(Ptr parts, int64_t m, int stride,
                                       T* warp_buf) {
  T s = T(0);
#pragma unroll 4
  for (int64_t j = threadIdx.x; j < m; j += kThreads) s = s + parts[j * stride];
  return block_tree(s, warp_buf);
}

// The dot products accumulate in double: the product of two floats is
// exact there, so r.z and r.r come out rounded once, nearly independent
// of the order of the sum.
__device__ __forceinline__ void update_row(float alpha, float xi, float ri,
                                           float pi, float api, float di,
                                           float& xo, float& ro, float& zo,
                                           double& rz, double& rr) {
  xo = xi + alpha * pi;
  ro = ri - alpha * api;
  zo = di * ro;
  rz = rz + (double)ro * (double)zo;
  rr = rr + (double)ro * (double)ro;
}

// x, r and z are updated in place (the TPU kernel returned new arrays):
// each thread reads and writes only its own rows.  The vectors are
// 16-byte aligned (the wrapper checks), so each chunk of four rows moves
// as float4; a ragged end of fewer than four rows goes row by row.
__global__ void __launch_bounds__(kThreads)
cg_update_kernel(const float* __restrict__ pap_parts, int64_t n_pap,
                 float* __restrict__ x, float* __restrict__ r,
                 const float* __restrict__ p, const float* __restrict__ ap,
                 const float* __restrict__ inv_diag, float* __restrict__ z,
                 int64_t n, double* partials, PcgState* state, int max_iter) {
  __shared__ float warp_buf[kWarps];
  __shared__ double warp_buf_d[kWarps];
  __shared__ float s_alpha;
  __shared__ bool s_last;
  // Uniform over the grid: only the last block of an earlier launch
  // writes the flag.
  if (state->stop) return;
  // Written by the previous launch: plain loads, through L2.
  const float pap = fixed_sum(pap_parts, n_pap, 1, warp_buf);
  if (threadIdx.x == 0) {
    // Every block reads the old rz here, before it takes its ticket; the
    // last block overwrites it only after all blocks have taken theirs.
    s_alpha = state->rz / (fabsf(pap) > 0.0f ? pap : kTiny);
  }
  __syncthreads();
  const float alpha = s_alpha;

  double rz = 0.0, rr = 0.0;
  const int64_t chunks = (n + 3) / 4;
  for (int64_t c = (int64_t)blockIdx.x * kThreads + threadIdx.x; c < chunks;
       c += (int64_t)gridDim.x * kThreads) {
    const int64_t i = 4 * c;
    if (i + 4 <= n) {
      const float4 xv = *reinterpret_cast<const float4*>(x + i);
      const float4 rv = *reinterpret_cast<const float4*>(r + i);
      const float4 pv = __ldg(reinterpret_cast<const float4*>(p + i));
      const float4 av = __ldg(reinterpret_cast<const float4*>(ap + i));
      const float4 dv = __ldg(reinterpret_cast<const float4*>(inv_diag + i));
      float4 xo, ro, zo;
      update_row(alpha, xv.x, rv.x, pv.x, av.x, dv.x, xo.x, ro.x, zo.x, rz, rr);
      update_row(alpha, xv.y, rv.y, pv.y, av.y, dv.y, xo.y, ro.y, zo.y, rz, rr);
      update_row(alpha, xv.z, rv.z, pv.z, av.z, dv.z, xo.z, ro.z, zo.z, rz, rr);
      update_row(alpha, xv.w, rv.w, pv.w, av.w, dv.w, xo.w, ro.w, zo.w, rz, rr);
      *reinterpret_cast<float4*>(x + i) = xo;
      *reinterpret_cast<float4*>(r + i) = ro;
      *reinterpret_cast<float4*>(z + i) = zo;
    } else {
      for (int64_t j = i; j < n; ++j) {
        float xo, ro, zo;
        update_row(alpha, x[j], r[j], p[j], ap[j], inv_diag[j], xo, ro, zo,
                   rz, rr);
        x[j] = xo;
        r[j] = ro;
        z[j] = zo;
      }
    }
  }
  const double rz_block = block_tree(rz, warp_buf_d);
  const double rr_block = block_tree(rr, warp_buf_d);

  // The threadfence reduction: publish the partials, then take a ticket.
  if (threadIdx.x == 0) {
    partials[2 * (int64_t)blockIdx.x] = rz_block;
    partials[2 * (int64_t)blockIdx.x + 1] = rr_block;
    __threadfence();
    s_last = atomicAdd(&state->ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const volatile double* vp = partials;
  const float rz_new = (float)fixed_sum(vp, gridDim.x, 2, warp_buf_d);
  const float rn2_new = (float)fixed_sum(vp + 1, gridDim.x, 2, warp_buf_d);
  if (threadIdx.x == 0) {
    // The launch ran, so the loop was live: take the new values.
    const float rz_old = state->rz;
    state->beta = rz_new / (rz_old != 0.0f ? rz_old : kTiny);
    state->rz = rz_new;
    state->rn2 = rn2_new;
    const int it = state->it + 1;
    state->it = it;
    const bool live = it < max_iter && isfinite(rz_new) && rz_new > 0.0f &&
                      sqrtf(rn2_new) > state->tol_b;
    state->live = live ? 1 : 0;
    state->stop = live ? 0 : 1;
    state->ticket = 0;
  }
}

// cudaSetDevice only when another device is current (otherwise every
// launch would pay for it).
inline cudaError_t use_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess || current == device) return err;
  return cudaSetDevice(device);
}

}  // namespace

// The PCG loop's two launches take their operands as one struct, filled
// once per solve (DirectionArgs and UpdateArgs in ops/kernels/cg_kernel.py
// mirror these layouts): a call then marshals one pointer, not fourteen
// arguments.
struct DirectionArgs {
  int device, nd;
  int threads, rows, tile, halo_lo, window, staged;  // the host's plan
  int64_t ndof;
  const float* beta;
  const float* z;
  const float* p;
  const float* diags;
  const int* offsets;  // int32, + halo_lo on the staged path
  const float* mask;
  float* p_out;
  float* ap_out;
  float* partial;      // one a block
  const unsigned char* stop;
  void* stream;
};

struct UpdateArgs {
  int device, max_iter;
  int64_t n_pap, n;
  const float* pap_parts;
  float* x;
  float* r;
  const float* p;
  const float* ap;
  const float* inv_diag;
  float* z;
  double* partials;  // 2 * kUpdateBlocks
  void* state;       // a PcgState whose ticket is 0
  void* stream;
};

static_assert(sizeof(DirectionArgs) == 128 && sizeof(UpdateArgs) == 104,
              "the ctypes mirrors in cg_kernel.py assume these layouts");

namespace {

template <int R, int T>
cudaError_t launch_dir_matvec(const DirectionArgs* a) {
  const int shared = 4 * ((a->staged ? 2 * a->window : 0) + a->nd);
  if (shared > 48 * 1024) {
    if (shared > kMaxSharedBytes) return cudaErrorInvalidValue;
    const cudaError_t err = cudaFuncSetAttribute(
        dia_dir_matvec_kernel<R, T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
    if (err != cudaSuccess) return err;
  }
  const unsigned int blocks =
      (unsigned int)((a->ndof + a->tile - 1) / a->tile);
  dia_dir_matvec_kernel<R, T><<<blocks, T, shared, (cudaStream_t)a->stream>>>(
      a->beta, a->z, a->p, a->diags, a->offsets, a->nd, a->ndof, a->mask,
      a->p_out, a->ap_out, a->partial, a->stop, a->tile, a->halo_lo,
      a->window, a->staged);
  return cudaSuccess;
}

}  // namespace

extern "C" {

int pft_threads_per_block() { return kThreads; }

int pft_update_blocks() { return kUpdateBlocks; }

const char* pft_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// threads * kRowsPerThread divides tile; offsets as for stencil_kernel.
int pft_dia_matvec(int device, const float* diags, const int* offsets,
                   int nd, int64_t ndof, const float* u, float* y,
                   int threads, int tile, int halo_lo, int window,
                   int staged, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (ndof > 0) {
    const int shared = 4 * ((staged ? window : 0) + nd);
    if (shared > 48 * 1024) {
      if (shared > kMaxSharedBytes) return (int)cudaErrorInvalidValue;
      err = cudaFuncSetAttribute(stencil_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 shared);
      if (err != cudaSuccess) return (int)err;
    }
    const unsigned int blocks = (unsigned int)((ndof + tile - 1) / tile);
    stencil_kernel<<<blocks, threads, shared, (cudaStream_t)stream>>>(
        diags, offsets, nd, ndof, u, y, tile, halo_lo, window, staged);
  }
  return (int)cudaGetLastError();
}

// rows (1, 2 or 4) and threads (32, 64 or 128) select the instantiation;
// R * threads divides tile, and tile and halo_lo are multiples of 4.
int pft_dia_dir_matvec(const DirectionArgs* a) {
  cudaError_t err = use_device(a->device);
  if (err != cudaSuccess) return (int)err;
  if (a->ndof > 0) {
    switch (a->rows * 1000 + a->threads) {
#define PFT_DIR(R, T) \
  case R * 1000 + T: err = launch_dir_matvec<R, T>(a); break;
      PFT_DIR(1, 32) PFT_DIR(1, 64) PFT_DIR(1, 128)
      PFT_DIR(2, 32) PFT_DIR(2, 64) PFT_DIR(2, 128)
      PFT_DIR(4, 32) PFT_DIR(4, 64) PFT_DIR(4, 128)
#undef PFT_DIR
      default: err = cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

int pft_cg_update(const UpdateArgs* a) {
  cudaError_t err = use_device(a->device);
  if (err != cudaSuccess) return (int)err;
  cg_update_kernel<<<kUpdateBlocks, kThreads, 0, (cudaStream_t)a->stream>>>(
      a->pap_parts, a->n_pap, a->x, a->r, a->p, a->ap, a->inv_diag, a->z,
      a->n, a->partials, static_cast<PcgState*>(a->state), a->max_iter);
  return (int)cudaGetLastError();
}

}  // extern "C"
