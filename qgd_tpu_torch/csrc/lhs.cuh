// Hopper (sm_90a) kernels for the implicit-stage matrix of the Hermite
// step: hermite_lhs_matrix_f32 replaces the Pallas kernel
//   qgd_tpu/ops/pallas_step.py:184 hermite_lhs_matrix_kernel_call
// (pallas_call :206, body _lhs_kernel :145-165).
//
// It computes, for each of B stacks At_k = (-dt)^(k+1) A_k (k < m) of
// n x n matrices, the recursion on the identity
//   D_0 = I,  D_{j+1} = 1/(j+1) * sum_{i<=j} At_{j-i} D_i
// and returns sum_{j=0..m} c_j D_j (B, n, n), c_j the Hermite weights.
// D_1 = At_0, so the first product is D_2 = (At_1 + At_0 At_0) / 2.
//
// What bounds it on the card: at the main-path shape (B = 256, n = 128,
// m = 2) the work is one 128^3 product per matrix, 1.074 GFLOP of FP32
// FMA (16.0 us at 67 TFLOP/s), against 50.3 MB that must move (the 33.6
// MB stack read once, the 16.8 MB result written once: 15.0 us at 3.35
// TB/s). The two bounds are nearly equal, so the design keeps the FMA
// pipe fed from shared memory and moves every byte once. The products
// stay in plain FP32 FMA (no TF32): the port pins full f32 products.
//
// lhs_staged_kernel (m >= 2, n <= 128, n % 4 == 0): one 256-thread block
// per matrix, one launch per call for levels 0 and 1 together.
//  * The scaled At_0 is staged whole in shared memory (128 x 132 floats,
//    66 KB; two blocks per SM, so all 256 matrices are resident in one
//    wave on 132 SMs) by 16-byte cp.async copies, read from device memory
//    once per block. The copies go out in four groups ordered by the
//    32-deep k-chunk that first needs them (row strip c and column strip c
//    of At_0), so the FMAs on chunk 0 start while chunks 1-3 still arrive.
//    Each thread scales, in place, the elements it copied itself.
//  * At_1, the i = 0 term, is loaded straight into the accumulators while
//    At_0 streams in: it is never staged and never read twice.
//  * Each thread owns an 8 x 8 register micro-tile (rows 4ty..4ty+3 and
//    64+4ty.., columns 4tx.. and 64+4tx..). Per 2-deep k step it loads one
//    float2 of each of its 8 rows and two float4 per k of the right
//    operand: 128 FMAs per 32 floats loaded (4 FMAs per float), with 8 +
//    16 operand registers beside the 64 accumulators (the float4-deep
//    version of the left operand spilled at the 128-register cap of two
//    blocks per SM). Conflict-free: the 132-float row pitch puts rows 4
//    apart on banks 16 apart.
//  * The epilogue forms c_0 I + c_1 At_0 + c_2 D_2 in registers and writes
//    the result once (and D_2 to scratch when m >= 3).
//  * lhs_staged_kernel<true> is the same code for n = 128 (the main path),
//    its k loop unrolled with the size known at compile time.
//
// lhs_level_kernel: every other shape (n > 128, the ragged n = 130 of the
// tests, m = 1) and the levels j >= 2 of every m >= 3 (order >= 6) after
// either first launch; one launch per recursion level, whose level 1 folds
// in level 0 (c_0 I + c_1 At_0 in its epilogue), so levels 0 and 1 are one
// launch on both paths. At (B, m, n) = (1, 2, 1024) it does one 1024^3
// product, 2.15 GFLOP (32 us at 67 TFLOP/s FP32) against 12.6 MB (3.8 us):
// the FMA rate bounds it, as at order 8 on the main path, (256, 4, 128),
// 6 products per matrix, 6.4 GFLOP (96 us).
//  * Level j's j products are one k-loop over [At_{j-1} .. At_0] times
//    [D_1; ..; D_j] (D_1 = At_0, D_2 .. D_{m-1} in the wrapper's scratch),
//    into a 128 x 128 output tile per block of 256 threads, each an 8 x 8
//    register micro-tile fed as in the staged kernel (4 FMAs per float read
//    from shared memory). Where 128 x 128 tiles would leave SMs without a
//    block (B = 1, n = 1024: 64 tiles), 128 x 64 tiles of 128 threads.
//  * The k-slices (32 deep) come by cp.async, 16 bytes a copy, into a ring
//    of 3 stages (4 for 128 x 64), so the loads of slices t+1, t+2 overlap
//    the FMAs of slice t; one barrier per slice. Each thread scales the
//    left slice's floats it copied, in place, by the product's step scale
//    (both operands' scales: D_1's s goes on the left).
//  * Ragged edges: copies outside n x n are zero-filled by the copy itself;
//    where n % 4 != 0 or the stack is not 16-byte aligned, the same code
//    copies one float at a time (kVec = false).
//  * The epilogue keeps the contract of every launch: D_{j+1} to scratch
//    while j+1 <= m-1, and out += c_{j+1} D_{j+1}.
//  * Products stay in plain FP32 FMA (no TF32).
//
// hermite_stage_pair_f32: the backward's pair of one-step matrices from one
// recursion, the counterpart of the JAX package's XLA function
// qgd_tpu/forward.py:158 _stage_matrices_both (R = sum_j dt^j c_j D_j, L =
// sum_j (-dt)^j c_j D_j). With the stack scaled at s = +dt the recursion's
// D_j carries dt^j, so R = E + O and L = E - O, E the even-j terms, O the
// odd-j ones: the same kernels, instantiated with kPair, share every
// product and write both sums in the epilogue (level j adds c_j D_j to R and
// (-1)^j c_j D_j to L). At the main-path shape the FMAs are the
// single-output kernel's (16.0 us) and the bytes grow by the second 16.8 MB
// output to 67.1 MB (20.0 us): the pair is bound by HBM bytes, and one
// launch moves each of them once where the plain build reads and writes
// the (B, m+1, n, n) derivative stack between its passes.

// The kernels and their launcher, shared by the two entry points: lhs.cu
// (hermite_lhs_matrix_f32) and pair.cu (hermite_stage_pair_f32), each
// compiled on its own, in parallel, instantiating only its own variants.

#pragma once

#include <cstdint>

#include "stage_common.cuh"

using hermite::Coeffs;
using hermite::cp_async16;
using hermite::cp_async16_zfill;
using hermite::cp_async4_zfill;
using hermite::cp_async_commit;
using hermite::cp_async_wait;
using hermite::scale4;
using hermite::step_base;
using hermite::step_scale;

namespace {

// ---------------------------------------------------------------------------
// staged path
// ---------------------------------------------------------------------------

constexpr int kStageDim = 128;           // largest n staged whole
constexpr int kStageLd = kStageDim + 4;  // padded row pitch (floats)
constexpr int kStageThreads = 256;       // 16 x 16, 8 x 8 outputs each
constexpr int kChunk = 32;               // k-depth of one copy group
constexpr int kStageSmem = kStageDim * kStageLd * sizeof(float);

// Visit the float4 slots (row, 4-column index) of At_0 that this thread
// copies in group c: row strip c from column 32c on, and column strip c
// below row strip c. Group c holds what k-chunk c needs first.
template <typename F>
__device__ __forceinline__ void for_group(int c, int n, int tid, F&& fn) {
  const int n4 = n / 4;
  const int col4 = c * (kChunk / 4) + (tid & 31);
  if (col4 < n4) {
    const int r_end = min(n, kChunk * (c + 1));
    for (int r = kChunk * c + (tid >> 5); r < r_end; r += 8) fn(r, col4);
  }
  const int col4b = c * (kChunk / 4) + (tid & 7);
  if (col4b < min(n4, (c + 1) * (kChunk / 4))) {
    for (int r = kChunk * (c + 1) + (tid >> 3); r < n; r += 32) fn(r, col4b);
  }
}

// kFull: n = 128 (the main path), with the size known at compile time so
// the k loop unrolls.
// kPair: out2 gets the pair's L (odd levels subtracted), out its R.
template <bool kFull, bool kPair>
__global__ void __launch_bounds__(kStageThreads, 2)
lhs_staged_kernel(const float* __restrict__ a, const float* dt_dev,
                  float dt_value, float sign, float* __restrict__ scratch,
                  float* __restrict__ out, float* __restrict__ out2,
                  Coeffs coeffs, int m, int n_arg) {
  extern __shared__ __align__(16) float sA[];  // At_0, kStageDim x kStageLd
  const int n = kFull ? kStageDim : n_arg;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const size_t nn = static_cast<size_t>(n) * n;
  const float* a0 = a + static_cast<size_t>(b) * m * nn;
  const float* a1 = a0 + nn;
  const int nchunks = (n + kChunk - 1) / kChunk;

  for (int c = 0; c < nchunks; ++c) {
    for_group(c, n, tid, [&](int r, int c4) {
      cp_async16(&sA[r * kStageLd + 4 * c4], a0 + static_cast<size_t>(r) * n +
                                                 4 * c4);
    });
    cp_async_commit();
  }

  const float s = step_base(dt_dev, dt_value, sign);
  const float scale0 = step_scale(s, 0);
  const float scale1 = step_scale(s, 1);

  // acc = At_1 (the i = 0 term of level 1), read while At_0 arrives.
  // Thread rows: 4ty + u (u < 4) and 64 + 4ty + (u - 4); columns likewise.
  float acc[8][8];
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int r = (u < 4 ? 0 : 64) + 4 * ty + (u & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = 64 * h + 4 * tx;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < n && col < n)
        v = __ldg(reinterpret_cast<const float4*>(
            a1 + static_cast<size_t>(r) * n + col));
      acc[u][4 * h + 0] = v.x * scale1;
      acc[u][4 * h + 1] = v.y * scale1;
      acc[u][4 * h + 2] = v.z * scale1;
      acc[u][4 * h + 3] = v.w * scale1;
    }
  }

  const float* a_rows = sA + 4 * ty * kStageLd;  // + u or 64 + u rows
  const float* b_cols = sA + 4 * tx;             // + k rows, + 64 columns
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait(nchunks - 1 - c);
    for_group(c, n, tid, [&](int r, int c4) {
      scale4(reinterpret_cast<float4*>(&sA[r * kStageLd + 4 * c4]), scale0);
    });
    __syncthreads();  // chunk c's rows and columns are in place, scaled
    const int k_end = kFull ? kChunk * (c + 1) : min(n, kChunk * (c + 1));
#pragma unroll 16
    for (int k = kChunk * c; k < k_end; k += 2) {
      // the left operand 2 deep (float2), so 16 + 8 of it live at a time
      float2 av[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        av[u] = *reinterpret_cast<const float2*>(
            a_rows + ((u < 4 ? 0 : 64) + (u & 3)) * kStageLd + k);
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const float4 b0 =
            *reinterpret_cast<const float4*>(b_cols + (k + kk) * kStageLd);
        const float4 b1 = *reinterpret_cast<const float4*>(
            b_cols + (k + kk) * kStageLd + 64);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const float a_uk = kk == 0 ? av[u].x : av[u].y;
#pragma unroll
          for (int v = 0; v < 8; ++v) acc[u][v] = fmaf(a_uk, bv[v], acc[u][v]);
        }
      }
    }
  }

  // out = c_0 I + c_1 D_1 + c_2 D_2, D_1 = At_0, D_2 = acc / 2 (the pair's
  // out2 = c_0 I - c_1 D_1 + c_2 D_2)
  const float c0 = coeffs.c[0];
  const float c1 = coeffs.c[1];
  const float c2 = coeffs.c[2];
  float* out_b = out + static_cast<size_t>(b) * nn;
  float* out2_b = kPair ? out2 + static_cast<size_t>(b) * nn : nullptr;
  float* d2 = m >= 3 ? scratch + static_cast<size_t>(b) * (m - 2) * nn
                     : nullptr;
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int r = (u < 4 ? 0 : 64) + 4 * ty + (u & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = 64 * h + 4 * tx;
      if (r < n && col < n) {
        const float4 at0 =
            *reinterpret_cast<const float4*>(&sA[r * kStageLd + col]);
        const float d1[4] = {at0.x, at0.y, at0.z, at0.w};
        float o[4], o2[4], d[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          d[q] = acc[u][4 * h + q] / 2.0f;
          const float eye = c0 * (r == col + q ? 1.0f : 0.0f);
          o[q] = (eye + c1 * d1[q]) + c2 * d[q];
          if (kPair) o2[q] = (eye - c1 * d1[q]) + c2 * d[q];
        }
        const size_t idx = static_cast<size_t>(r) * n + col;
        *reinterpret_cast<float4*>(out_b + idx) =
            make_float4(o[0], o[1], o[2], o[3]);
        if (kPair)
          *reinterpret_cast<float4*>(out2_b + idx) =
              make_float4(o2[0], o2[1], o2[2], o2[3]);
        if (d2 != nullptr)
          *reinterpret_cast<float4*>(d2 + idx) =
              make_float4(d[0], d[1], d[2], d[3]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// level path: one launch per level j, a 128 x kBN tile of D_{j+1} per block
// ---------------------------------------------------------------------------

constexpr int kBM = 128;           // tile rows
constexpr int kBK = 32;            // k-depth of one slice
constexpr int kALd = kBK + 4;      // row pitch of a left slice (floats)
constexpr int kLevelThreads = 256;

// A kBM x kBN tile, each thread a kTM x 8 register micro-tile: 128 x 128
// with 8 x 8, or 128 x 64 with 4 x 8 (twice the blocks, for small grids).
template <int kBN, int kTM>
struct LevelTile {
  static constexpr int kCols = kBN / 8;    // threads along a tile row
  static_assert(kCols * (kBM / kTM) == kLevelThreads, "256 threads");
  static constexpr int kBLd = kBN + 4;     // row pitch of a right slice
  static constexpr int kStages = kBN == 128 ? 3 : 4;
  static constexpr int kStageFloats = kBM * kALd + kBK * kBLd;
  static constexpr int kSmem = kStages * kStageFloats * sizeof(float);
  // 16-byte copy slots of a thread: left rows lrow + 32 q (q < 4), right
  // rows rrow + kRightStep q (q < kRightCopies)
  static constexpr int kRightRun = kBN / 4;  // threads per right row
  static constexpr int kRightStep = kLevelThreads / kRightRun;
  static constexpr int kRightCopies = kBK / kRightStep;
};

// Start the copy of the 4 floats at src (row ok, columns c .. c+3 of an
// n-wide matrix) into shared memory, zeros where outside; `any` is a valid
// address to name when nothing is read. kVec (n % 4 == 0, 16-byte aligned
// operands): one 16-byte cp.async, else four 4-byte ones.
template <bool kVec>
__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      const float* any, bool row_ok, int c,
                                      int n) {
  if (kVec) {
    const bool inside = row_ok && c < n;
    cp_async16_zfill(dst, inside ? src : any, inside ? 16 : 0);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const bool inside = row_ok && c + q < n;
      cp_async4_zfill(dst + q, inside ? src + q : any, inside ? 4 : 0);
    }
  }
}

// v = the 4 floats at (r, c) of g, zeros outside n x n
template <bool kVec>
__device__ __forceinline__ void load4(const float* g, int r, int c, int n,
                                      float (&v)[4]) {
  const float* p = g + static_cast<size_t>(r) * n + c;
  if (kVec) {
    const float4 t = r < n && c < n ? *reinterpret_cast<const float4*>(p)
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = r < n && c + q < n ? p[q] : 0.0f;
  }
}

template <bool kVec>
__device__ __forceinline__ void store4(float* g, int r, int c, int n,
                                       const float (&v)[4]) {
  float* p = g + static_cast<size_t>(r) * n + c;
  if (kVec) {
    if (r < n && c < n)
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (r < n && c + q < n) p[q] = v[q];
  }
}

// Level j of the recursion on the identity for one kBM x kBN tile of one
// element: D_{j+1} = (At_j + sum_{i=1..j} At_{j-i} D_i) / (j+1), the j
// products as one k-loop over [At_{j-1} .. At_0] [D_1; ..; D_j] (D_1 =
// At_0, D_2 .. D_{m-1} in scratch (B, m-2, n, n)); D_{j+1} to scratch while
// j+1 <= m-1, and out += c_{j+1} D_{j+1} (level 1 starts out at c_0 I +
// c_1 D_1, level 0 (m = 1) at c_0 I). kPair: out2 gets the same sums with
// the odd levels subtracted (the pair's L).
template <int kBN, int kTM, bool kVec, bool kPair>
__global__ void __launch_bounds__(kLevelThreads, 2)
lhs_level_kernel(const float* __restrict__ a, const float* dt_dev,
                 float dt_value, float sign, float* __restrict__ scratch,
                 float* __restrict__ out, float* __restrict__ out2,
                 Coeffs coeffs, int m, int n, int j) {
  using T = LevelTile<kBN, kTM>;
  extern __shared__ __align__(16) float smem[];  // kStages x (left, right)
  const int tiles_c = (n + kBN - 1) / kBN;
  const int per_matrix = ((n + kBM - 1) / kBM) * tiles_c;
  const int b = blockIdx.x / per_matrix;
  const int tile = blockIdx.x - b * per_matrix;
  const int row0 = (tile / tiles_c) * kBM;
  const int col0 = (tile % tiles_c) * kBN;
  const int tid = threadIdx.x;
  const int tx = tid % T::kCols;
  const int ty = tid / T::kCols;
  const size_t nn = static_cast<size_t>(n) * n;
  const float* a_b = a + static_cast<size_t>(b) * m * nn;
  const float s = step_base(dt_dev, dt_value, sign);
  const int kt = (n + kBK - 1) / kBK;  // slices per product
  const int slices = j * kt;

  // slice t: product i = 1 + t / kt, k in [32 (t % kt), +32): the left
  // operand's 128 x 32 (8 threads per 128-byte row run), the right's
  // 32 x kBN (kBN/4 threads per row run)
  const int lrow = tid >> 3;
  const int lcol = 4 * (tid & 7);
  const int rrow = tid / T::kRightRun;
  const int rcol = col0 + 4 * (tid % T::kRightRun);
  const float* left0 = a_b + static_cast<size_t>(row0 + lrow) * n + lcol;
  const float* d_first = a_b + static_cast<size_t>(rrow) * n + rcol;
  const float* d_later =
      m >= 3 ? scratch + static_cast<size_t>(b) * (m - 2) * nn +
                   static_cast<size_t>(rrow) * n + rcol
             : nullptr;
  auto copy_slice = [&](int t) {
    float* sa = smem + (t % T::kStages) * T::kStageFloats;
    float* sb = sa + kBM * kALd;
    const int i = 1 + t / kt;
    const int k0 = (t % kt) * kBK;
    const float* lp = left0 + static_cast<size_t>(j - i) * nn + k0;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      copy4<kVec>(sa + (lrow + 32 * q) * kALd + lcol,
                  lp + static_cast<size_t>(32 * q) * n, a,
                  row0 + lrow + 32 * q < n, k0 + lcol, n);
    const float* rp = (i == 1 ? d_first
                              : d_later + static_cast<size_t>(i - 2) * nn) +
                      static_cast<size_t>(k0) * n;
#pragma unroll
    for (int q = 0; q < T::kRightCopies; ++q)
      copy4<kVec>(sb + (rrow + T::kRightStep * q) * T::kBLd + rcol - col0,
                  rp + static_cast<size_t>(T::kRightStep * q) * n, a,
                  k0 + rrow + T::kRightStep * q < n, rcol, n);
  };
  // the product's scale s^(j-i+1) (times s for D_1 = At_0), on the left
  // slice in place, each thread on the floats it copied itself
  auto scale_left = [&](int t) {
    float* sa = smem + (t % T::kStages) * T::kStageFloats;
    const int i = 1 + t / kt;
    const float scale =
        step_scale(s, j - i) * (i == 1 ? step_scale(s, 0) : 1.0f);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      scale4(reinterpret_cast<float4*>(sa + (lrow + 32 * q) * kALd + lcol),
             scale);
  };

  for (int t = 0; t < T::kStages - 1; ++t) {
    if (t < slices) copy_slice(t);
    cp_async_commit();  // one group per slice index, empty past the end
  }

  // the i = 0 term, At_j D_0 = At_j, read while the first slices arrive.
  // Thread rows: 4ty + u (u < 4) and, for 8-row micro-tiles, 64 + 4ty +
  // (u - 4); columns 4tx + v and kBN/2 + 4tx + (v - 4).
  float acc[kTM][8];
  {
    const float scale_j = step_scale(s, j);
    const float* a_j = a_b + static_cast<size_t>(j) * nn;
#pragma unroll
    for (int u = 0; u < kTM; ++u)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v[4];
        load4<kVec>(a_j, row0 + (u >> 2) * 64 + 4 * ty + (u & 3),
                    col0 + h * (kBN / 2) + 4 * tx, n, v);
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[u][4 * h + q] = v[q] * scale_j;
      }
  }

  for (int t = 0; t < slices; ++t) {
    cp_async_wait(T::kStages - 2);  // this thread's copies of slice t
    scale_left(t);
    __syncthreads();  // slice t in place for all; slice t-1 consumed
    if (t + T::kStages - 1 < slices) copy_slice(t + T::kStages - 1);
    cp_async_commit();
    const float* sa = smem + (t % T::kStages) * T::kStageFloats;
    const float* a_rows = sa + 4 * ty * kALd;                 // + u rows
    const float* b_cols = sa + kBM * kALd + 4 * tx;           // + k rows
#pragma unroll
    for (int k = 0; k < kBK; k += 2) {
      // the left operand 2 deep (float2): 2 kTM + 8 operand registers
      // beside the 8 kTM sums; 8 x 8: 4 FMAs per float read from shared
      // memory, 4 x 8: 2.7
      float2 av[kTM];
#pragma unroll
      for (int u = 0; u < kTM; ++u)
        av[u] = *reinterpret_cast<const float2*>(
            a_rows + ((u >> 2) * 64 + (u & 3)) * kALd + k);
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const float4 b0 =
            *reinterpret_cast<const float4*>(b_cols + (k + kk) * T::kBLd);
        const float4 b1 = *reinterpret_cast<const float4*>(
            b_cols + (k + kk) * T::kBLd + kBN / 2);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int u = 0; u < kTM; ++u) {
          const float a_uk = kk == 0 ? av[u].x : av[u].y;
#pragma unroll
          for (int v = 0; v < 8; ++v) acc[u][v] = fmaf(a_uk, bv[v], acc[u][v]);
        }
      }
    }
  }

  // D_{j+1} = acc / (j+1); out = c_0 I + c_1 D_1 + c_2 D_2 + ..., summed
  // in that order: level 0 starts at c_0 I, level 1 at c_0 I + c_1 D_1,
  // a later level at what the level before wrote
  const float div = static_cast<float>(j + 1);
  float* d_next = j >= 1 && j + 1 <= m - 1
      ? scratch + (static_cast<size_t>(b) * (m - 2) + (j - 1)) * nn
      : nullptr;
  float* out_b = out + static_cast<size_t>(b) * nn;
  float* out2_b = kPair ? out2 + static_cast<size_t>(b) * nn : nullptr;
  const float scale0 = step_scale(s, 0);
  const float c_next = coeffs.c[j + 1];
  // the pair's L weighs D_{j+1} by (-1)^(j+1)
  const float c_next2 = (j + 1) % 2 == 1 ? -c_next : c_next;
#pragma unroll
  for (int u = 0; u < kTM; ++u) {
    const int r = row0 + (u >> 2) * 64 + 4 * ty + (u & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = col0 + h * (kBN / 2) + 4 * tx;
      float d[4], prev[4], prev2[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) d[q] = acc[u][4 * h + q] / div;
      if (j <= 1) {
        float d1[4] = {0.f, 0.f, 0.f, 0.f};
        if (j == 1) load4<kVec>(a_b, r, col, n, d1);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float eye = coeffs.c[0] * (r == col + q ? 1.0f : 0.0f);
          prev[q] = eye;
          prev2[q] = eye;
          if (j == 1) {
            prev[q] = eye + coeffs.c[1] * (d1[q] * scale0);
            prev2[q] = eye - coeffs.c[1] * (d1[q] * scale0);
          }
        }
      } else {
        load4<kVec>(out_b, r, col, n, prev);
        if (kPair) load4<kVec>(out2_b, r, col, n, prev2);
      }
      float o[4], o2[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        o[q] = prev[q] + c_next * d[q];
        if (kPair) o2[q] = prev2[q] + c_next2 * d[q];
      }
      if (d_next != nullptr) store4<kVec>(d_next, r, col, n, d);
      store4<kVec>(out_b, r, col, n, o);
      if (kPair) store4<kVec>(out2_b, r, col, n, o2);
    }
  }
}

// Launch level j over every tile of every matrix; each instantiation may
// use the block's full shared memory once set per device.
template <int kBN, int kTM, bool kVec, bool kPair>
cudaError_t launch_level(const float* a, const float* dt, float dt_value,
                         float sign, float* scratch, float* out, float* out2,
                         const Coeffs& coeffs, int batch, int m, int n,
                         int j, cudaStream_t st) {
  using T = LevelTile<kBN, kTM>;
  static unsigned smem_set = 0;
  const cudaError_t err = hermite::allow_full_smem(
      reinterpret_cast<const void*>(lhs_level_kernel<kBN, kTM, kVec, kPair>),
      &smem_set);
  if (err != cudaSuccess) return err;
  const long long blocks = static_cast<long long>(batch) *
                           ((n + kBM - 1) / kBM) * ((n + kBN - 1) / kBN);
  lhs_level_kernel<kBN, kTM, kVec, kPair>
      <<<static_cast<unsigned>(blocks), kLevelThreads, T::kSmem, st>>>(
          a, dt, dt_value, sign, scratch, out, out2, coeffs, m, n, j);
  return cudaGetLastError();
}

template <bool kFull, bool kPair>
cudaError_t launch_staged(const float* a, const float* dt, float dt_value,
                          float sign, float* scratch, float* out, float* out2,
                          const Coeffs& coeffs, int batch, int m, int n,
                          cudaStream_t st) {
  static unsigned smem_set = 0;
  const cudaError_t err = hermite::allow_full_smem(
      reinterpret_cast<const void*>(lhs_staged_kernel<kFull, kPair>),
      &smem_set);
  if (err != cudaSuccess) return err;
  lhs_staged_kernel<kFull, kPair><<<batch, kStageThreads, kStageSmem, st>>>(
      a, dt, dt_value, sign, scratch, out, out2, coeffs, m, n);
  return cudaGetLastError();
}

// One call of either entry point: out (and, kPair, out2) for the B stacks.
template <bool kPair>
int launch_stage(const float* a, const float* dt, float dt_value, float sign,
                 float* scratch, float* out, float* out2,
                 const float* coeffs_host, int batch, int m, int n,
                 void* stream) {
  if (m < 1 || m > hermite::kMaxLevels || n < 1 || batch < 1)
    return hermite::kShapeRefused;
  if (m >= 3 && scratch == nullptr) return hermite::kShapeRefused;
  const Coeffs coeffs = hermite::make_coeffs(coeffs_host, m);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool aligned = reinterpret_cast<std::uintptr_t>(a) % 16 == 0;
  // 128 x 128 tiles unless they would not give every SM a block; then
  // 128 x 64 (B = 1, n = 1024: 128 tiles, not 64)
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles_r = (n + kBM - 1) / kBM;
  const bool wide = static_cast<long long>(batch) * tiles_r * tiles_r >= sms;
  if (static_cast<long long>(batch) * tiles_r * ((n + 63) / 64) > 0x7fffffffLL)
    return hermite::kShapeRefused;
  const bool vec = n % 4 == 0 && aligned;
  auto level = [&](int j) {
    if (wide)
      return vec ? launch_level<128, 8, true, kPair>(
                       a, dt, dt_value, sign, scratch, out, out2, coeffs,
                       batch, m, n, j, st)
                 : launch_level<128, 8, false, kPair>(
                       a, dt, dt_value, sign, scratch, out, out2, coeffs,
                       batch, m, n, j, st);
    return vec ? launch_level<64, 4, true, kPair>(a, dt, dt_value, sign,
                                                  scratch, out, out2, coeffs,
                                                  batch, m, n, j, st)
               : launch_level<64, 4, false, kPair>(a, dt, dt_value, sign,
                                                   scratch, out, out2, coeffs,
                                                   batch, m, n, j, st);
  };
  const bool staged = m >= 2 && n <= kStageDim && n % 4 == 0 && aligned;
  if (staged) {
    err = n == kStageDim
              ? launch_staged<true, kPair>(a, dt, dt_value, sign, scratch,
                                           out, out2, coeffs, batch, m, n, st)
              : launch_staged<false, kPair>(a, dt, dt_value, sign, scratch,
                                            out, out2, coeffs, batch, m, n,
                                            st);
  } else {
    err = level(m == 1 ? 0 : 1);  // levels 0 and 1 in one launch
  }
  for (int j = 2; j < m && err == cudaSuccess; ++j) err = level(j);
  return static_cast<int>(err);
}

}  // namespace

