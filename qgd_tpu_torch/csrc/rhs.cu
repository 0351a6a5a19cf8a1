// Hopper (sm_90a) kernels for the explicit half of the Hermite step:
// hermite_rhs_f32 replaces the Pallas kernel
//   qgd_tpu/ops/pallas_step.py:91 hermite_rhs_kernel_call
// (pallas_call :116, body _rhs_kernel :62-74).
//
// It computes, for each of B stacks At_k = dt^(k+1) A_k (k < m) of n x n
// matrices and states W (n x b), the recursion
//   W_0 = W,  W_{j+1} = 1/(j+1) * sum_{i<=j} At_{j-i} W_i
// and returns sum_{j=0..m} c_j W_j (B, n, b), c_j the Hermite weights.
//
// What bounds it on the card: at the main-path shape (B = 256, n = 128,
// m = 2, b = 8) it must read the 33.6 MB stack and move 2.1 MB of states
// (35.7 MB: 10.6 us at 3.35 TB/s) for 0.201 GFLOP (3.0 us at 67 TFLOP/s
// FP32): 2b FLOP per element of At read, so HBM bytes bound it, and the
// design is about reading each byte once with enough of them in flight.
//
// rhs_stream_kernel (n <= 128, n % 4 == 0): one 256-thread block per
// batch element, at the main shape 110 KB of shared memory, so two blocks
// per SM and all 256 elements in one wave on 132 SMs, with every byte of
// the stack requested at kernel start.
//  * At_0, used by every level, is copied once into shared memory by
//    16-byte cp.async (one warp per 512-byte row). At_1 .. At_{m-1} are
//    prefetched into L2 by one bulk prefetch and streamed from there by
//    the level that needs them, read coalesced straight into registers:
//    at m = 2 each element of the stack is read from device memory once
//    (the PR 1 ring kernel streamed At_0 twice, ~50 MB for 33.5 MB).
//  * Streamed products (At_k W_{j-k}, k >= 1) run warp per 16 rows, lane
//    per 4 k's with that W slice in registers; the 8 column sums of a row
//    are reduced across the warp by a reduce-scatter of 9 shuffles. The
//    ones on the input state, At_k W_0, run first, while At_0 is still
//    arriving: at m = 2 that is the only streamed product.
//  * Products with At_0 run k-sliced: warp ks takes k in [16ks, 16ks+16),
//    each lane 4 rows (lane + 32i) and 8 state columns in registers, so
//    per 4-deep k step four float4 of At_0 (conflict-free: the 4-float row
//    padding puts the rows of a warp on distinct banks) and eight
//    broadcast float4 of W feed 128 FMAs; the 8 slices' partial sums meet
//    in shared memory.
//  * The state levels stay in shared memory; the last level's reduction
//    forms the result from them and writes it once.
//  * rhs_stream_kernel<true> is the same code for n = 128, b <= 8 (the
//    main path), with the sizes known at compile time.
//  * Design taken over a 2-CTA cluster per element (64 rows of each At in
//    each CTA, W_1's halves exchanged through distributed shared memory):
//    streaming At_1 from L2 already halves the shared memory a block
//    needs, with no cross-block exchange.
//
// rhs_ring_kernel: the general path (n > 128, n % 4 != 0, or state levels
// too large to hold): 128 threads, one row each, the state levels in shared
// memory and At streamed through a 4-deep ring of 128 x 32 tiles by
// cp.async, once per level that uses it.
//
// Plain C interface (no PyTorch headers), loaded with ctypes. Each entry
// point launches on the given stream, allocates nothing, and returns
// cudaGetLastError() (or kShapeRefused) so a refused launch is reported.

#include <cuda_pipeline.h>

#include <cstdint>

#include "stage_common.cuh"

using hermite::Coeffs;
using hermite::cp_async16;
using hermite::cp_async_commit;
using hermite::cp_async_wait;
using hermite::round_up;
using hermite::scale4;
using hermite::step_base;
using hermite::step_scale;

namespace {

// ---------------------------------------------------------------------------
// stream path
// ---------------------------------------------------------------------------

constexpr int kStreamThreads = 256;
constexpr int kStreamRows = 128;  // largest n
constexpr int kSlices = 8;        // k-slices of the At_0 products: one per warp
constexpr int kSliceDepth = 16;   // k per slice
constexpr int kColBlock = 8;      // state columns per pass

size_t stream_smem(int m, int n, int bc) {
  return (static_cast<size_t>(n) * (n + 4) +
          static_cast<size_t>(m + 1) * n * round_up(bc, kColBlock) +
          static_cast<size_t>(kSlices) * kStreamRows * kColBlock) *
         sizeof(float);
}

// P[r][cb..cb+7] (=, or += when accumulate) of (scale * gA) W for the
// n x n matrix gA in device memory and the state level sW (n x bp): warp w
// takes rows 16w..16w+15, lane l the k's 4l..4l+3 with W[4l..4l+3][cb..]
// in registers; the 8 sums of a row are reduced across the warp.
template <bool kFull>
__device__ __forceinline__ void stream_product(const float* __restrict__ gA,
                                               float scale, const float* sW,
                                               float* P, int n, int bp,
                                               bool accumulate, int tid) {
  if (kFull) {
    n = kStreamRows;
    bp = kColBlock;
  }
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
  const int col = (b4 ? 4 : 0) + (b3 ? 2 : 0) + (b2 ? 1 : 0);
  const bool k_ok = kFull || 4 * lane < n;
  const int r_end = kFull ? 16 * warp + 16 : min(n, 16 * warp + 16);
  for (int cb = 0; cb < bp; cb += kColBlock) {
    float wr[4][kColBlock];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float4 w0 = make_float4(0.f, 0.f, 0.f, 0.f), w1 = w0;
      if (k_ok) {
        w0 = *reinterpret_cast<const float4*>(sW + (4 * lane + q) * bp + cb);
        w1 = *reinterpret_cast<const float4*>(sW + (4 * lane + q) * bp + cb +
                                              4);
      }
      wr[q][0] = w0.x; wr[q][1] = w0.y; wr[q][2] = w0.z; wr[q][3] = w0.w;
      wr[q][4] = w1.x; wr[q][5] = w1.y; wr[q][6] = w1.z; wr[q][7] = w1.w;
    }
#pragma unroll 1
    for (int r0 = 16 * warp; r0 < r_end; r0 += 8) {
      float4 av[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        av[i] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (kFull || (k_ok && r0 + i < r_end))
          av[i] = __ldg(reinterpret_cast<const float4*>(
              gA + static_cast<size_t>(r0 + i) * n + 4 * lane));
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (!kFull && r0 + i >= r_end) break;  // warp-uniform
        const float a4[4] = {av[i].x * scale, av[i].y * scale,
                             av[i].z * scale, av[i].w * scale};
        float p[kColBlock];
#pragma unroll
        for (int c = 0; c < kColBlock; ++c) {
          float t = a4[0] * wr[0][c];
          t = fmaf(a4[1], wr[1][c], t);
          t = fmaf(a4[2], wr[2][c], t);
          p[c] = fmaf(a4[3], wr[3][c], t);
        }
        // reduce-scatter: lane bits 4, 3, 2 pick the column, bits 1, 0 sum
        float q4[4];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          q4[c] = (b4 ? p[c + 4] : p[c]) +
                  __shfl_xor_sync(0xffffffffu, b4 ? p[c] : p[c + 4], 16);
        float q2[2];
#pragma unroll
        for (int c = 0; c < 2; ++c)
          q2[c] = (b3 ? q4[c + 2] : q4[c]) +
                  __shfl_xor_sync(0xffffffffu, b3 ? q4[c] : q4[c + 2], 8);
        float v = (b2 ? q2[1] : q2[0]) +
                  __shfl_xor_sync(0xffffffffu, b2 ? q2[0] : q2[1], 4);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        if ((lane & 3) == 0) {
          float* dst = P + (r0 + i) * bp + cb + col;
          *dst = accumulate ? *dst + v : v;
        }
      }
    }
  }
}

// kFull: the main-path shape class n = 128, b <= 8, with the sizes known
// at compile time (the loops unroll and the masks fold away).
template <bool kFull>
__global__ void __launch_bounds__(kStreamThreads, 2)
rhs_stream_kernel(const float* __restrict__ a, const float* dt_dev,
                  float dt_value, float sign, const float* __restrict__ w,
                  float* __restrict__ out, Coeffs coeffs, int m, int n_arg,
                  int bc) {
  // [At_0, n x (n+4)][(m+1) state levels n x bp, zero past column bc]
  // [kSlices partial sums kStreamRows x kColBlock]
  extern __shared__ __align__(16) float smem[];
  const int n = kFull ? kStreamRows : n_arg;
  const int ld = n + 4;
  const int bp = kFull ? kColBlock : round_up(bc, kColBlock);
  const int level = n * bp;
  float* sA = smem;
  float* sW = smem + n * ld;
  float* part = sW + (m + 1) * level;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t nn = static_cast<size_t>(n) * n;
  const float* a_b = a + static_cast<size_t>(b) * m * nn;
  const float* w_b = w + static_cast<size_t>(b) * n * bc;

  // this thread's copy slots of At_0: 4-column index tid % 32 of rows
  // tid/32 + 8q
  const int col4 = tid & 31;
  const bool copies = col4 < n / 4;
  if (copies)
    for (int r = tid >> 5; r < n; r += 8)
      cp_async16(sA + r * ld + 4 * col4,
                 a_b + static_cast<size_t>(r) * n + 4 * col4);
  cp_async_commit();
  if (tid == 0 && m > 1)
    asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" ::"l"(a_b + nn),
                 "r"(static_cast<unsigned>((m - 1) * nn * sizeof(float)))
                 : "memory");
  for (int e = tid; e < level; e += kStreamThreads) {
    const int r = e / bp;
    const int c = e - r * bp;
    sW[e] = c < bc ? w_b[static_cast<size_t>(r) * bc + c] : 0.0f;
  }
  __syncthreads();  // W_0 in place

  const float s = step_base(dt_dev, dt_value, sign);
  // the streamed terms on W_0, At_k W_0 into W_{k+1} (k = 1..m-1), while
  // At_0 is still arriving
  for (int k = 1; k < m; ++k)
    stream_product<kFull>(a_b + k * nn, step_scale(s, k), sW,
                          sW + (k + 1) * level, n, bp, false, tid);
  const int rg = tid & 31;
  const int k0 = kSliceDepth * (tid >> 5);
  const int k1 = kFull ? k0 + kSliceDepth : min(n, k0 + kSliceDepth);
  for (int j = 0; j < m; ++j) {
    float* w_next = sW + (j + 1) * level;
    // the other streamed terms At_k W_{j-k}, 1 <= k < j, onto w_next
    for (int k = 1; k < j; ++k)
      stream_product<kFull>(a_b + k * nn, step_scale(s, k),
                            sW + (j - k) * level, w_next, n, bp, true, tid);
    if (j == 0) {
      cp_async_wait(0);
      if (copies) {
        const float scale = step_scale(s, 0);
        for (int r = tid >> 5; r < n; r += 8)
          scale4(reinterpret_cast<float4*>(sA + r * ld + 4 * col4), scale);
      }
      __syncthreads();  // At_0 scaled in place
    }
    // At_0 W_j, k-sliced, one block of 8 state columns at a time
    for (int cb = 0; cb < bp; cb += kColBlock) {
      float acc[4][kColBlock];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < kColBlock; ++c) acc[i][c] = 0.0f;
      const float* w_j = sW + j * level + cb;
#pragma unroll 4
      for (int k = k0; k < k1; k += 4) {
        float4 av[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          av[i] = rg + 32 * i < n ? *reinterpret_cast<const float4*>(
                                        sA + (rg + 32 * i) * ld + k)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float4 w0 =
              *reinterpret_cast<const float4*>(w_j + (k + kk) * bp);
          const float4 w1 =
              *reinterpret_cast<const float4*>(w_j + (k + kk) * bp + 4);
          const float wv[kColBlock] = {w0.x, w0.y, w0.z, w0.w,
                                       w1.x, w1.y, w1.z, w1.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float a_ik = kk == 0   ? av[i].x
                               : kk == 1 ? av[i].y
                               : kk == 2 ? av[i].z
                                         : av[i].w;
#pragma unroll
            for (int c = 0; c < kColBlock; ++c)
              acc[i][c] = fmaf(a_ik, wv[c], acc[i][c]);
          }
        }
      }
      float* part_s = part + (tid >> 5) * kStreamRows * kColBlock;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float* dst = part_s + (rg + 32 * i) * kColBlock;
        *reinterpret_cast<float4*>(dst) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        *reinterpret_cast<float4*>(dst + 4) =
            make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
      }
      __syncthreads();  // every slice's partial sums written
      // W_{j+1} = (streamed terms + sum of the slices) / (j+1)
      const int row = tid >> 1;
      const int c = (tid & 1) * 4;
      if (row < n) {
        float* dst = w_next + row * bp + cb + c;
        float4 t = j > 0 ? *reinterpret_cast<const float4*>(dst)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int q = 0; q < kSlices; ++q) {
          const float4 p = *reinterpret_cast<const float4*>(
              part + (q * kStreamRows + row) * kColBlock + c);
          t.x += p.x;
          t.y += p.y;
          t.z += p.z;
          t.w += p.w;
        }
        const float div = static_cast<float>(j + 1);
        t = make_float4(t.x / div, t.y / div, t.z / div, t.w / div);
        if (j + 1 < m) {
          *reinterpret_cast<float4*>(dst) = t;
        } else {
          // the last level: out = c_0 W_0 + c_1 W_1 + ... + c_m W_m,
          // summed in that order, for this thread's row and 4 columns
          const float wm[4] = {t.x, t.y, t.z, t.w};
          float* out_r = out + (static_cast<size_t>(b) * n + row) * bc;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int col = cb + c + q;
            if (col < bc) {
              float o = coeffs.c[0] * sW[row * bp + col];
              for (int jj = 1; jj < m; ++jj)
                o = o + coeffs.c[jj] * sW[jj * level + row * bp + col];
              out_r[col] = o + coeffs.c[m] * wm[q];
            }
          }
        }
      }
      __syncthreads();  // W_{j+1}'s block complete; partials free again
    }
  }
}

// ---------------------------------------------------------------------------
// ring path: one block per batch element, all m levels in one launch
// ---------------------------------------------------------------------------

constexpr int kRhsThreads = 128;  // rows per tile, one per thread
constexpr int kRhsDepth = 32;     // k-depth of a tile
constexpr int kRhsStages = 4;     // tiles in the ring
constexpr int kColChunk = 8;      // state columns per register block
constexpr int kTileFloats = kRhsThreads * (kRhsDepth + 1);

size_t ring_smem(int m, int n, int bc) {
  return (hermite::kMaxLevels +
          static_cast<size_t>(kRhsStages) * kTileFloats +
          static_cast<size_t>(m + 1) * round_up(n, kRhsDepth) *
              round_up(bc, kColChunk)) *
         sizeof(float);
}

// Start the copy of the tile rows r0.., columns k0.. of the n x n matrix
// a_i into tile (row stride kRhsDepth+1); entries outside a_i are zeroed.
// Thread tid copies column k0 + tid%32 of rows tid/32 + 4q.
__device__ __forceinline__ void copy_tile_async(float* tile, const float* a_i,
                                                int r0, int k0, int n,
                                                int tid) {
  const int kk = tid % kRhsDepth;
  const int gk = k0 + kk;
#pragma unroll
  for (int q = 0; q < kRhsDepth; ++q) {
    const int rr = tid / kRhsDepth + q * (kRhsThreads / kRhsDepth);
    const int gr = r0 + rr;
    const bool inside = gr < n && gk < n;
    const float* src = inside ? a_i + static_cast<size_t>(gr) * n + gk : a_i;
    __pipeline_memcpy_async(tile + rr * (kRhsDepth + 1) + kk, src,
                            sizeof(float), inside ? 0 : sizeof(float));
  }
}

__global__ void __launch_bounds__(kRhsThreads)
rhs_ring_kernel(const float* __restrict__ a, const float* dt_dev,
                float dt_value, float sign, const float* __restrict__ w,
                float* __restrict__ out, Coeffs coeffs, int m, int n,
                int bc) {
  // [kMaxLevels step scales][kRhsStages tiles][(m+1) levels of
  // n_pad x bc_pad, row-major, zero outside n x bc]
  extern __shared__ __align__(16) float smem[];
  float* scales = smem;
  float* ring = smem + hermite::kMaxLevels;
  float* sW = ring + kRhsStages * kTileFloats;
  const int n_pad = round_up(n, kRhsDepth);
  const int bc_pad = round_up(bc, kColChunk);
  const int ktiles = n_pad / kRhsDepth;
  const size_t level = static_cast<size_t>(n_pad) * bc_pad;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t nn = static_cast<size_t>(n) * n;
  const float* a_b = a + static_cast<size_t>(b) * m * nn;
  const float* w_b = w + static_cast<size_t>(b) * n * bc;

  if (tid < m) scales[tid] = step_scale(step_base(dt_dev, dt_value, sign),
                                        tid);
  for (size_t e = tid; e < (m + 1) * level; e += kRhsThreads) {
    const int k = static_cast<int>(e / bc_pad);  // row within level 0
    const int c = static_cast<int>(e % bc_pad);
    sW[e] = (e < level && k < n && c < bc)
                ? w_b[static_cast<size_t>(k) * bc + c] : 0.0f;
  }
  __syncthreads();

  for (int j = 0; j < m; ++j) {
    float* w_next = sW + static_cast<size_t>(j + 1) * level;
    const float div = static_cast<float>(j + 1);
    // tile t of this level: product i = t / ktiles (At_{j-i} W_i),
    // k-slice t % ktiles
    const int ntiles = (j + 1) * ktiles;
    for (int r0 = 0; r0 < n; r0 += kRhsThreads) {
      for (int cb = 0; cb < bc_pad; cb += kColChunk) {
        // one commit per tile index, empty past the end, so that
        // "all but the newest kRhsStages-1 groups done" means "tile t done"
        auto issue = [&](int t) {
          if (t < ntiles)
            copy_tile_async(ring + (t % kRhsStages) * kTileFloats,
                            a_b + static_cast<size_t>(j - t / ktiles) * nn,
                            r0, (t % ktiles) * kRhsDepth, n, tid);
          __pipeline_commit();
        };
        for (int t = 0; t < kRhsStages - 1; ++t) issue(t);
        float acc[kColChunk];
#pragma unroll
        for (int cc = 0; cc < kColChunk; ++cc) acc[cc] = 0.0f;
        for (int t = 0; t < ntiles; ++t) {
          issue(t + kRhsStages - 1);  // into the buffer freed at t-1
          __pipeline_wait_prior(kRhsStages - 1);
          __syncthreads();  // every thread's copies of tile t have landed
          const float* row = ring + (t % kRhsStages) * kTileFloats +
                             tid * (kRhsDepth + 1);
          const float scale = scales[j - t / ktiles];
          const float* w_t = sW + static_cast<size_t>(t / ktiles) * level +
                             static_cast<size_t>(t % ktiles) * kRhsDepth *
                                 bc_pad + cb;
#pragma unroll 8
          for (int kk = 0; kk < kRhsDepth; ++kk) {
            const float av = row[kk] * scale;
            const float4* wk = reinterpret_cast<const float4*>(
                w_t + static_cast<size_t>(kk) * bc_pad);
            const float4 lo = wk[0];
            const float4 hi = wk[1];
            acc[0] = fmaf(av, lo.x, acc[0]);
            acc[1] = fmaf(av, lo.y, acc[1]);
            acc[2] = fmaf(av, lo.z, acc[2]);
            acc[3] = fmaf(av, lo.w, acc[3]);
            acc[4] = fmaf(av, hi.x, acc[4]);
            acc[5] = fmaf(av, hi.y, acc[5]);
            acc[6] = fmaf(av, hi.z, acc[6]);
            acc[7] = fmaf(av, hi.w, acc[7]);
          }
          __syncthreads();  // tile t's buffer may be refilled
        }
        const int r = r0 + tid;
        if (r < n) {
#pragma unroll
          for (int cc = 0; cc < kColChunk; ++cc)
            w_next[static_cast<size_t>(r) * bc_pad + cb + cc] = acc[cc] / div;
        }
      }
    }
    __syncthreads();
  }

  // out = c_0 W_0 + c_1 W_1 + ... + c_m W_m, summed in that order
  float* out_b = out + static_cast<size_t>(b) * n * bc;
  for (int e = tid; e < n * bc; e += kRhsThreads) {
    const size_t off = static_cast<size_t>(e / bc) * bc_pad + e % bc;
    float o = coeffs.c[0] * sW[off];
    for (int jj = 1; jj <= m; ++jj) o = o + coeffs.c[jj] * sW[jj * level + off];
    out_b[e] = o;
  }
}

// devices where each kernel may use the block's full shared memory
unsigned g_stream_smem_set[2] = {0, 0};
unsigned g_ring_smem_set = 0;

}  // namespace

extern "C" {

// a: (B, m, n, n) stack; dt: one float on the device, or null to use
// dt_value; the step scales are (sign*dt)^(k+1); w: (B, n, bc);
// out: (B, n, bc); coeffs_host: m+1 floats.
int hermite_rhs_f32(const float* a, const float* dt, float dt_value,
                    float sign, const float* w, float* out,
                    const float* coeffs_host, int batch, int m, int n, int bc,
                    void* stream) {
  if (m < 1 || m > hermite::kMaxLevels || n < 1 || bc < 1 || batch < 1)
    return hermite::kShapeRefused;
  const Coeffs coeffs = hermite::make_coeffs(coeffs_host, m);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t stream_bytes = stream_smem(m, n, bc);
  if (n <= kStreamRows && n % 4 == 0 &&
      reinterpret_cast<std::uintptr_t>(a) % 16 == 0 &&
      stream_bytes <= hermite::kMaxSharedBytes) {
    const bool full = n == kStreamRows && bc <= kColBlock;
    const void* fn =
        full ? reinterpret_cast<const void*>(rhs_stream_kernel<true>)
             : reinterpret_cast<const void*>(rhs_stream_kernel<false>);
    const cudaError_t err =
        hermite::allow_full_smem(fn, &g_stream_smem_set[full ? 1 : 0]);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (full)
      rhs_stream_kernel<true><<<batch, kStreamThreads, stream_bytes, st>>>(
          a, dt, dt_value, sign, w, out, coeffs, m, n, bc);
    else
      rhs_stream_kernel<false><<<batch, kStreamThreads, stream_bytes, st>>>(
          a, dt, dt_value, sign, w, out, coeffs, m, n, bc);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t ring_bytes = ring_smem(m, n, bc);
  if (ring_bytes > hermite::kMaxSharedBytes) return hermite::kShapeRefused;
  if (ring_bytes > 48 * 1024) {
    const cudaError_t err = hermite::allow_full_smem(
        reinterpret_cast<const void*>(rhs_ring_kernel), &g_ring_smem_set);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  rhs_ring_kernel<<<batch, kRhsThreads, ring_bytes, st>>>(
      a, dt, dt_value, sign, w, out, coeffs, m, n, bc);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
