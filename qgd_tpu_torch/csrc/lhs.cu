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
// lhs_level_kernel: the general path, one launch per recursion level,
// 64 x 64 output tiles from 16-deep shared slices (4 x 4 micro-tiles).
// It takes every n (the ragged n = 130 of the tests, n > 128), m = 1, and
// the levels j >= 2 of m >= 3 after either first launch; its level 1
// folds in level 0 (c_0 I + c_1 At_0 in its epilogue), so levels 0 and 1
// are one launch on both paths. D_2 .. D_{m-1} go through the wrapper's
// scratch.
//
// Plain C interface (no PyTorch headers), loaded with ctypes. Each entry
// point launches on the given stream, allocates nothing, and returns
// cudaGetLastError() (or kShapeRefused) so a refused launch is reported.

#include <cstdint>

#include "stage_common.cuh"

using hermite::Coeffs;
using hermite::cp_async16;
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
template <bool kFull>
__global__ void __launch_bounds__(kStageThreads, 2)
lhs_staged_kernel(const float* __restrict__ a, const float* dt_dev,
                  float dt_value, float sign, float* __restrict__ scratch,
                  float* __restrict__ out, Coeffs coeffs, int m, int n_arg) {
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

  // out = c_0 I + c_1 D_1 + c_2 D_2, D_1 = At_0, D_2 = acc / 2
  const float c0 = coeffs.c[0];
  const float c1 = coeffs.c[1];
  const float c2 = coeffs.c[2];
  float* out_b = out + static_cast<size_t>(b) * nn;
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
        float o[4], d[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          d[q] = acc[u][4 * h + q] / 2.0f;
          const float prev = c0 * (r == col + q ? 1.0f : 0.0f) + c1 * d1[q];
          o[q] = prev + c2 * d[q];
        }
        const size_t idx = static_cast<size_t>(r) * n + col;
        *reinterpret_cast<float4*>(out_b + idx) =
            make_float4(o[0], o[1], o[2], o[3]);
        if (d2 != nullptr)
          *reinterpret_cast<float4*>(d2 + idx) =
              make_float4(d[0], d[1], d[2], d[3]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// level path: one launch per level j, grid (B, ceil(n/64), ceil(n/64))
// ---------------------------------------------------------------------------

constexpr int kTile = 64;
constexpr int kDepth = 16;
constexpr int kEdge = 16;              // threads per tile edge
constexpr int kMicro = kTile / kEdge;  // outputs per thread per edge

__device__ __forceinline__ const float* lhs_level(const float* a,
                                                  const float* scratch,
                                                  int b, int i, int m,
                                                  int n) {
  const size_t nn = static_cast<size_t>(n) * n;
  if (i == 1) return a + static_cast<size_t>(b) * m * nn;  // D_1 = At_0
  return scratch + (static_cast<size_t>(b) * (m - 2) + (i - 2)) * nn;
}

__global__ void __launch_bounds__(kEdge * kEdge)
lhs_level_kernel(const float* __restrict__ a, const float* dt_dev,
                 float dt_value, float sign, float* __restrict__ scratch,
                 float* __restrict__ out, Coeffs coeffs, int m, int n,
                 int j) {
  // +4 padding: the transposed A-tile store hits 2-way, not 16-way,
  // bank conflicts
  __shared__ float sA[kDepth][kTile + 4];
  __shared__ float sD[kDepth][kTile];

  const int b = blockIdx.x;
  const int r0 = blockIdx.y * kTile;
  const int c0 = blockIdx.z * kTile;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kEdge + tx;
  const size_t nn = static_cast<size_t>(n) * n;
  const float* a_b = a + static_cast<size_t>(b) * m * nn;
  const float s = step_base(dt_dev, dt_value, sign);

  // i = 0 term: At_j * D_0 = At_j
  const float scale_j = step_scale(s, j);
  float acc[kMicro][kMicro];
#pragma unroll
  for (int u = 0; u < kMicro; ++u) {
    const int r = r0 + ty + kEdge * u;
#pragma unroll
    for (int v = 0; v < kMicro; ++v) {
      const int c = c0 + tx + kEdge * v;
      acc[u][v] = (r < n && c < n)
                      ? a_b[j * nn + static_cast<size_t>(r) * n + c] * scale_j
                      : 0.0f;
    }
  }

  const float scale0 = step_scale(s, 0);
  for (int i = 1; i <= j; ++i) {
    const float* lhs = a_b + static_cast<size_t>(j - i) * nn;  // At_{j-i}
    const float* rhs = lhs_level(a, scratch, b, i, m, n);      // D_i
    const float scale_l = step_scale(s, j - i);
    const float scale_r = (i == 1) ? scale0 : 1.0f;  // D_1 = At_0
    for (int k0 = 0; k0 < n; k0 += kDepth) {
      // A tile (64 rows x 16 deep): 16 consecutive threads read one row
      // slice; stored transposed as sA[k][row]
#pragma unroll
      for (int q = 0; q < (kTile * kDepth) / (kEdge * kEdge); ++q) {
        const int e = tid + q * kEdge * kEdge;
        const int rr = e / kDepth;
        const int kk = e % kDepth;
        const int r = r0 + rr;
        const int k = k0 + kk;
        sA[kk][rr] = (r < n && k < n)
                         ? lhs[static_cast<size_t>(r) * n + k] * scale_l
                         : 0.0f;
      }
      // D tile (16 deep x 64 columns): 64 consecutive threads read one row
#pragma unroll
      for (int q = 0; q < (kTile * kDepth) / (kEdge * kEdge); ++q) {
        const int e = tid + q * kEdge * kEdge;
        const int kk = e / kTile;
        const int cc = e % kTile;
        const int k = k0 + kk;
        const int c = c0 + cc;
        sD[kk][cc] = (k < n && c < n)
                         ? rhs[static_cast<size_t>(k) * n + c] * scale_r
                         : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kDepth; ++kk) {
        float av[kMicro], dv[kMicro];
#pragma unroll
        for (int u = 0; u < kMicro; ++u) av[u] = sA[kk][ty + kEdge * u];
#pragma unroll
        for (int v = 0; v < kMicro; ++v) dv[v] = sD[kk][tx + kEdge * v];
#pragma unroll
        for (int u = 0; u < kMicro; ++u)
#pragma unroll
          for (int v = 0; v < kMicro; ++v)
            acc[u][v] = fmaf(av[u], dv[v], acc[u][v]);
      }
      __syncthreads();
    }
  }

  const float inv_div = static_cast<float>(j + 1);
  const bool store_level = (j >= 1) && (j + 1 <= m - 1);
  float* d_next = store_level
      ? scratch + (static_cast<size_t>(b) * (m - 2) + (j - 1)) * nn
      : nullptr;
  float* out_b = out + static_cast<size_t>(b) * nn;
  const float c_next = coeffs.c[j + 1];
#pragma unroll
  for (int u = 0; u < kMicro; ++u) {
    const int r = r0 + ty + kEdge * u;
#pragma unroll
    for (int v = 0; v < kMicro; ++v) {
      const int c = c0 + tx + kEdge * v;
      if (r < n && c < n) {
        const size_t idx = static_cast<size_t>(r) * n + c;
        const float d = acc[u][v] / inv_div;
        if (store_level) d_next[idx] = d;
        // out = c_0 I + c_1 D_1 + c_2 D_2 + ..., summed in that order;
        // level 1 forms levels 0 and 1 together (D_1 = At_0)
        const float eye = coeffs.c[0] * (r == c ? 1.0f : 0.0f);
        const float prev =
            j == 0   ? eye
            : j == 1 ? eye + coeffs.c[1] * (a_b[idx] * scale0)
                     : out_b[idx];
        out_b[idx] = prev + c_next * d;
      }
    }
  }
}

// devices where the staged kernel may use its dynamic shared memory
unsigned g_staged_smem_set[2] = {0, 0};

}  // namespace

extern "C" {

// a: (B, m, n, n) stack; dt: one float on the device, or null to use
// dt_value; the step scales are (sign*dt)^(k+1); scratch: (B, m-2, n, n)
// when m >= 3 (unused otherwise); out: (B, n, n); coeffs_host: m+1 floats.
int hermite_lhs_matrix_f32(const float* a, const float* dt, float dt_value,
                           float sign, float* scratch, float* out,
                           const float* coeffs_host, int batch, int m, int n,
                           void* stream) {
  if (m < 1 || m > hermite::kMaxLevels || n < 1 || batch < 1)
    return hermite::kShapeRefused;
  const Coeffs coeffs = hermite::make_coeffs(coeffs_host, m);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool staged = m >= 2 && n <= kStageDim && n % 4 == 0 &&
                      reinterpret_cast<std::uintptr_t>(a) % 16 == 0;
  if (staged) {
    const bool full = n == kStageDim;
    const void* fn =
        full ? reinterpret_cast<const void*>(lhs_staged_kernel<true>)
             : reinterpret_cast<const void*>(lhs_staged_kernel<false>);
    const cudaError_t err =
        hermite::allow_full_smem(fn, &g_staged_smem_set[full ? 1 : 0]);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (full)
      lhs_staged_kernel<true><<<batch, kStageThreads, kStageSmem, st>>>(
          a, dt, dt_value, sign, scratch, out, coeffs, m, n);
    else
      lhs_staged_kernel<false><<<batch, kStageThreads, kStageSmem, st>>>(
          a, dt, dt_value, sign, scratch, out, coeffs, m, n);
  } else {
    const int tiles = (n + kTile - 1) / kTile;
    lhs_level_kernel<<<dim3(batch, tiles, tiles), dim3(kEdge, kEdge), 0,
                       st>>>(a, dt, dt_value, sign, scratch, out, coeffs, m,
                             n, m == 1 ? 0 : 1);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (n + kTile - 1) / kTile;
  for (int j = 2; j < m; ++j) {
    lhs_level_kernel<<<dim3(batch, tiles, tiles), dim3(kEdge, kEdge), 0,
                       st>>>(a, dt, dt_value, sign, scratch, out, coeffs, m,
                             n, j);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

}  // extern "C"
