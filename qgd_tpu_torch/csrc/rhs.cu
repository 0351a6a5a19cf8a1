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
//    (a kernel streaming At_0 once per level reads ~50 MB for 33.5 MB).
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
// rhs_level_kernel: every other shape (n > 128, n % 4 != 0, state levels
// too large for the stream kernel's shared memory), one launch per level.
// At (B, n, b) = (1, 1024, 8), m = 2 (the GMRES operator of a 512-level
// system) it must read 8.4 MB (2.5 us at 3.35 TB/s) for 50 MFLOP: bytes
// bound it, and the design is about requesting them from many SMs at once.
//  * An element's rows are spread over blocks of 8 rows (grid: B x n/8
//    blocks of 256 threads): 128 blocks fill the card's 132 SMs at B = 1,
//    n = 1024, where one block per element used one SM.
//  * Each block asks for all its rows of At_0 .. At_j at once (one L2
//    bulk prefetch per matrix: 8 rows are one contiguous run), then warp w
//    reads k in [128w, 128w+128) of every row (a float4 per lane, 512
//    contiguous bytes per row), the lane's 4 x 8 slice of W_i in registers,
//    8 rows x 8 columns of sums in registers across all terms i; the sums
//    meet by shuffles within the warp and in shared memory across warps.
//  * The state levels W_1 .. W_{m-1} live in the wrapper's scratch (B, m-1,
//    n, b) and are read through L2: nothing in shared memory grows with n,
//    m or b, so no shape with m <= 16 is refused.
//  * One launch per level (m per call; the last forms sum_j c_j W_j): W_{j+1}
//    needs every row of W_j, and the launch boundary is that barrier. A
//    cooperative grid barrier would need every block resident, which a
//    large batch is not; a cluster holds too few SMs for B = 1.
//  * Each row's reduction order is fixed (lanes, then warps 0..7), so a
//    result does not change from run to run.

// Plain C interface (no PyTorch headers), loaded with ctypes. Each entry
// point launches on the given stream, allocates nothing, and returns
// cudaGetLastError() (or kShapeRefused) so a refused launch is reported.

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

// The column whose sum reduce_scatter8 leaves in `lane`: lane bits 4, 3, 2.
__device__ __forceinline__ int scatter_col(int lane) {
  return (lane >> 2) & 7;
}

// Sum p[0..7] over the 32 lanes of the warp, one column per group of 4
// lanes: lanes with lane % 4 == 0 get the sum of column scatter_col(lane)
// (9 shuffles; lane bits 4, 3, 2 pick the column, bits 1, 0 sum).
__device__ __forceinline__ float reduce_scatter8(const float (&p)[kColBlock],
                                                 int lane) {
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
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
  return v;
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
  const int col = scatter_col(lane);
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
        const float v = reduce_scatter8(p, lane);
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
    hermite::prefetch_l2(a_b + nn,
                         static_cast<unsigned>((m - 1) * nn * sizeof(float)));
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
// level path: one launch per recursion level, an element's rows spread
// over blocks
// ---------------------------------------------------------------------------

constexpr int kLevelThreads = 256;  // 8 warps
constexpr int kLevelWarps = kLevelThreads / 32;
constexpr int kLevelRows = 8;       // rows of W_{j+1} per block
constexpr int kWarpK = 128;         // k's of one warp step: 4 per lane
constexpr size_t kPrefetchBytes = 32u << 20;  // of the 50 MB L2

// State level i of element b: W_0 is the input, W_1 .. W_{m-1} live in
// the wrapper's scratch (B, m-1, n, bc); both have row stride bc.
__device__ __forceinline__ const float* rhs_level(const float* w,
                                                  const float* scratch,
                                                  int b, int i, int m, int n,
                                                  int bc) {
  const size_t level = static_cast<size_t>(n) * bc;
  if (i == 0) return w + static_cast<size_t>(b) * level;
  return scratch + (static_cast<size_t>(b) * (m - 1) + (i - 1)) * level;
}

// Level j of the recursion for rows r0 .. r0+7 of one element:
// W_{j+1} = 1/(j+1) sum_{i<=j} At_{j-i} W_i into scratch, or, at the last
// level, out = sum_j c_j W_j. kVec: n % 4 == 0 and the stack 16-byte
// aligned, so each lane reads its 4 k's of a row as one float4.
template <bool kVec>
__global__ void __launch_bounds__(kLevelThreads)
rhs_level_kernel(const float* __restrict__ a, const float* dt_dev,
                 float dt_value, float sign, const float* __restrict__ w,
                 float* __restrict__ scratch, float* __restrict__ out,
                 Coeffs coeffs, int m, int n, int bc, int j) {
  __shared__ float part[kLevelWarps][kLevelRows][kColBlock];
  const int row_tiles = (n + kLevelRows - 1) / kLevelRows;
  const int b = blockIdx.x / row_tiles;
  const int r0 = (blockIdx.x - b * row_tiles) * kLevelRows;
  const int rows = min(kLevelRows, n - r0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t nn = static_cast<size_t>(n) * n;
  const float* a_b = a + static_cast<size_t>(b) * m * nn;

  // every byte this block reads of At_0 .. At_j (its rows of each: one
  // contiguous run) requested into L2 at once, so the loads below wait on
  // L2, not on device memory; skipped where the level's matrices would
  // not stay in L2 until read
  const size_t level_bytes =
      (j + 1) * nn * sizeof(float) * (gridDim.x / row_tiles);
  if (kVec && tid == 0 && level_bytes <= kPrefetchBytes)
    for (int k = 0; k <= j; ++k)
      hermite::prefetch_l2(a_b + k * nn + static_cast<size_t>(r0) * n,
                           static_cast<unsigned>(rows * n * sizeof(float)));

  const float s = step_base(dt_dev, dt_value, sign);
  const float div = static_cast<float>(j + 1);
  const int bp = round_up(bc, kColBlock);
  const int k_first = kWarpK * warp + 4 * lane;
  for (int cb = 0; cb < bp; cb += kColBlock) {
    float acc[kLevelRows][kColBlock];
#pragma unroll
    for (int r = 0; r < kLevelRows; ++r)
#pragma unroll
      for (int c = 0; c < kColBlock; ++c) acc[r][c] = 0.0f;
    for (int i = 0; i <= j; ++i) {
      const float* gA =
          a_b + static_cast<size_t>(j - i) * nn + static_cast<size_t>(r0) * n;
      const float scale = step_scale(s, j - i);
      const float* w_i = rhs_level(w, scratch, b, i, m, n, bc) + cb;
      for (int k = k_first; k < n; k += kWarpK * kLevelWarps) {
        // this lane's 4 k's of W_i, 8 columns, zero outside n x bc
        float wr[4][kColBlock];
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int c = 0; c < kColBlock; ++c)
            wr[q][c] = (k + q < n && cb + c < bc)
                           ? w_i[static_cast<size_t>(k + q) * bc + c]
                           : 0.0f;
        // the same 4 k's of the block's rows: per row, a warp reads 512
        // contiguous bytes
        float av[kLevelRows][4];
#pragma unroll
        for (int r = 0; r < kLevelRows; ++r) {
          const float* src = gA + static_cast<size_t>(r) * n + k;
          if (r >= rows) {
            av[r][0] = av[r][1] = av[r][2] = av[r][3] = 0.0f;
          } else if (kVec) {
            const float4 v = __ldg(reinterpret_cast<const float4*>(src));
            av[r][0] = v.x; av[r][1] = v.y; av[r][2] = v.z; av[r][3] = v.w;
          } else {
#pragma unroll
            for (int q = 0; q < 4; ++q)
              av[r][q] = k + q < n ? __ldg(src + q) : 0.0f;
          }
        }
#pragma unroll
        for (int r = 0; r < kLevelRows; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float a_rk = av[r][q] * scale;
#pragma unroll
            for (int c = 0; c < kColBlock; ++c)
              acc[r][c] = fmaf(a_rk, wr[q][c], acc[r][c]);
          }
      }
    }
    // each row's 8 column sums: across the lanes by shuffles, then across
    // the warps (each its 128-k slices) through shared memory
#pragma unroll
    for (int r = 0; r < kLevelRows; ++r) {
      const float v = reduce_scatter8(acc[r], lane);
      if ((lane & 3) == 0) part[warp][r][scatter_col(lane)] = v;
    }
    __syncthreads();
    if (tid < kLevelRows * kColBlock) {
      const int r = tid / kColBlock;
      const int c = tid % kColBlock;
      const int row = r0 + r;
      const int col = cb + c;
      float t = 0.0f;
#pragma unroll
      for (int q = 0; q < kLevelWarps; ++q) t += part[q][r][c];
      t = t / div;
      if (r < rows && col < bc) {
        const size_t e = static_cast<size_t>(row) * bc + col;
        if (j + 1 < m) {
          scratch[(static_cast<size_t>(b) * (m - 1) + j) * n * bc + e] = t;
        } else {
          // out = c_0 W_0 + c_1 W_1 + ... + c_m W_m, summed in that order
          float o = coeffs.c[0] * rhs_level(w, scratch, b, 0, m, n, bc)[e];
          for (int jj = 1; jj < m; ++jj)
            o = o + coeffs.c[jj] * rhs_level(w, scratch, b, jj, m, n, bc)[e];
          out[static_cast<size_t>(b) * n * bc + e] = o + coeffs.c[m] * t;
        }
      }
    }
    __syncthreads();  // partials free for the next column block
  }
}

bool aligned16(const float* a) {
  return reinterpret_cast<std::uintptr_t>(a) % 16 == 0;
}

// the stream path takes this shape (m >= 1 assumed); a_aligned: the stack
// starts on a 16-byte boundary
bool takes_stream(bool a_aligned, int m, int n, int bc) {
  return n <= kStreamRows && n % 4 == 0 && a_aligned &&
         stream_smem(m, n, bc) <= hermite::kMaxSharedBytes;
}

// devices where each stream kernel may use the block's full shared memory
unsigned g_stream_smem_set[2] = {0, 0};

}  // namespace

extern "C" {

// Floats of scratch hermite_rhs_f32 needs for these arguments (a_aligned:
// the stack starts on a 16-byte boundary): the state levels W_1 .. W_{m-1}
// of the level path, none on the stream path.
long long hermite_rhs_scratch_floats(int a_aligned, int batch, int m, int n,
                                     int bc) {
  if (m < 2 || takes_stream(a_aligned != 0, m, n, bc)) return 0;
  return static_cast<long long>(batch) * (m - 1) * n * bc;
}

// a: (B, m, n, n) stack; dt: one float on the device, or null to use
// dt_value; the step scales are (sign*dt)^(k+1); w: (B, n, bc); scratch:
// hermite_rhs_scratch_floats(...) floats (null when that is 0);
// out: (B, n, bc); coeffs_host: m+1 floats.
int hermite_rhs_f32(const float* a, const float* dt, float dt_value,
                    float sign, const float* w, float* scratch, float* out,
                    const float* coeffs_host, int batch, int m, int n, int bc,
                    void* stream) {
  if (m < 1 || m > hermite::kMaxLevels || n < 1 || bc < 1 || batch < 1)
    return hermite::kShapeRefused;
  const Coeffs coeffs = hermite::make_coeffs(coeffs_host, m);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (takes_stream(aligned16(a), m, n, bc)) {
    const size_t stream_bytes = stream_smem(m, n, bc);
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
  if (m >= 2 && scratch == nullptr) return hermite::kShapeRefused;
  const long long blocks =
      static_cast<long long>(batch) * ((n + kLevelRows - 1) / kLevelRows);
  if (blocks > 0x7fffffffLL) return hermite::kShapeRefused;
  const bool vec = n % 4 == 0 && aligned16(a);
  for (int j = 0; j < m; ++j) {
    if (vec)
      rhs_level_kernel<true><<<static_cast<unsigned>(blocks), kLevelThreads,
                               0, st>>>(a, dt, dt_value, sign, w, scratch,
                                        out, coeffs, m, n, bc, j);
    else
      rhs_level_kernel<false><<<static_cast<unsigned>(blocks), kLevelThreads,
                                0, st>>>(a, dt, dt_value, sign, w, scratch,
                                         out, coeffs, m, n, bc, j);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

}  // extern "C"
