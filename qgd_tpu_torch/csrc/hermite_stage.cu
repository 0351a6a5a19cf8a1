// Hopper (sm_90a) kernels for the two stage recursions of the Hermite step.
//
// Both take the generator stack A_k (k = 0..m-1) and the m step scales
// s^(k+1) (device memory, f32), and multiply each element by its scale as
// it is read, At_k = s^(k+1) A_k: the same single f32 rounding as scaling
// the stack beforehand, without writing a scaled copy. The recursion
//   X_0 = X,  X_{j+1} = 1/(j+1) * sum_{i<=j} At_{j-i} X_i
// gives X_j = s^j * (scaled derivative j), and the result is
//   sum_{j=0..m} c_j X_j
// with the constant Hermite weights c_j passed by value.
//
// hermite_lhs_matrix_f32 replaces the Pallas kernel
//   qgd_tpu/ops/pallas_step.py:184 hermite_lhs_matrix_kernel_call
// (X_0 = I: the dense implicit-stage matrix, (B, n, n)).
// hermite_rhs_f32 replaces the Pallas kernel
//   qgd_tpu/ops/pallas_step.py:91 hermite_rhs_kernel_call
// (X_0 = W (B, n, b): the explicit half of a step).
//
// Plain C interface (no PyTorch headers), loaded with ctypes. Each entry
// point launches on the given stream, allocates nothing, and returns
// cudaGetLastError() so a refused launch is reported to the caller.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 16;  // largest m (order 32)

struct Coeffs {
  float c[kMaxLevels + 1];
};

// ---------------------------------------------------------------------------
// LHS: one launch per recursion level j, grid (B, ceil(n/64), ceil(n/64)).
//
// What bounds it: at the main-path shape (B=256, n=128, m=2) the levels
// hold 256 x 2*128^3 FLOP = 1.07 GFLOP of FP32 FMA (3.2 GFLOP at m=3)
// against ~48 MB moved, i.e. ~20+ FLOP/byte: FP32 FMA throughput bounds
// it, not memory. Each block computes one 64x64 output tile with 16x16
// threads, each holding a 4x4 register micro-tile, and stages 16-deep
// slices of both operands in shared memory, so every shared-memory load
// feeds four FMAs. D_0 = I is never multiplied: the i = 0 term
// At_j * I = At_j is read directly, and D_1 = At_0 / 1 = At_0 exactly, so
// level 1 reads At_0 in its place. Only D_2 .. D_{m-1} go to scratch.
// ---------------------------------------------------------------------------

constexpr int kTile = 64;
constexpr int kDepth = 16;
constexpr int kEdge = 16;               // threads per tile edge
constexpr int kMicro = kTile / kEdge;   // outputs per thread per edge

__device__ __forceinline__ const float* lhs_level(const float* a,
                                                  const float* scratch,
                                                  int b, int i, int m,
                                                  int n) {
  const size_t nn = static_cast<size_t>(n) * n;
  if (i == 1) return a + static_cast<size_t>(b) * m * nn;  // D_1 = At_0
  return scratch + (static_cast<size_t>(b) * (m - 2) + (i - 2)) * nn;
}

__global__ void __launch_bounds__(kEdge * kEdge)
lhs_level_kernel(const float* __restrict__ a,
                 const float* __restrict__ scales,
                 float* __restrict__ scratch, float* __restrict__ out,
                 Coeffs coeffs, int m, int n, int j) {
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

  // i = 0 term: At_j * D_0 = At_j
  const float scale_j = scales[j];
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

  for (int i = 1; i <= j; ++i) {
    const float* lhs = a_b + static_cast<size_t>(j - i) * nn;  // At_{j-i}
    const float* rhs = lhs_level(a, scratch, b, i, m, n);      // D_i
    const float scale_l = scales[j - i];
    const float scale_r = (i == 1) ? scales[0] : 1.0f;  // D_1 = At_0
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
        // out = c_0 I + c_1 D_1 + c_2 D_2 + ..., summed in that order
        const float prev = (j == 0) ? coeffs.c[0] * (r == c ? 1.0f : 0.0f)
                                    : out_b[idx];
        out_b[idx] = prev + c_next * d;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// RHS: one block per batch element, all m levels in one launch.
//
// What bounds it: every level reads its At slices from device memory
// (~32 MB of At per call at B=256, n=128, m=2) and does only 2*b = 16 FLOP
// per element read: bandwidth-bound. The state levels W_0 .. W_m live in
// shared memory for the whole recursion, zero-padded to n_pad x bc_pad
// (12 KB at the main shape, 28 KB at m=6), so only At travels. Each
// thread owns one row of the product and 8 state columns in registers,
// so no cross-lane reduction is needed. At streams through a ring of
// kRhsStages shared-memory tiles (128 rows x 32 deep) filled by cp.async,
// kRhsStages-1 tiles ahead of the one being multiplied: the copies need
// no registers, 32 threads copy one 128-byte row slice, and enough bytes
// are in flight to cover device-memory latency. The row-per-thread tile
// reads are conflict-free through a +1 padding; the state values are
// float4 broadcasts.
// ---------------------------------------------------------------------------

constexpr int kRhsThreads = 128;  // rows per tile, one per thread
constexpr int kRhsDepth = 32;     // k-depth of a tile
constexpr int kRhsStages = 4;     // tiles in the ring
constexpr int kColChunk = 8;      // state columns per register block
constexpr int kTileFloats = kRhsThreads * (kRhsDepth + 1);

__host__ __device__ inline int round_up(int x, int to) {
  return (x + to - 1) / to * to;
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
rhs_kernel(const float* __restrict__ a, const float* __restrict__ scales,
           const float* __restrict__ w, float* __restrict__ out,
           Coeffs coeffs, int m, int n, int bc) {
  // [kRhsStages tiles][(m+1) levels of n_pad x bc_pad, row-major, zero
  // outside n x bc]
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;
  float* sW = smem + kRhsStages * kTileFloats;
  const int n_pad = round_up(n, kRhsDepth);
  const int bc_pad = round_up(bc, kColChunk);
  const int ktiles = n_pad / kRhsDepth;
  const size_t level = static_cast<size_t>(n_pad) * bc_pad;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t nn = static_cast<size_t>(n) * n;
  const float* a_b = a + static_cast<size_t>(b) * m * nn;
  const float* w_b = w + static_cast<size_t>(b) * n * bc;

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

Coeffs make_coeffs(const float* host, int m) {
  Coeffs c{};
  for (int j = 0; j <= m; ++j) c.c[j] = host[j];
  return c;
}

}  // namespace

extern "C" {

int hermite_stage_max_levels() { return kMaxLevels; }

// a: (B, m, n, n) stack; scales: m floats on the device; scratch:
// (B, m-2, n, n) when m >= 3 (unused otherwise); out: (B, n, n);
// coeffs_host: m+1 floats on the host.
int hermite_lhs_matrix_f32(const float* a, const float* scales,
                           float* scratch, float* out,
                           const float* coeffs_host, int batch, int m, int n,
                           void* stream) {
  if (m < 1 || m > kMaxLevels || n < 1 || batch < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Coeffs coeffs = make_coeffs(coeffs_host, m);
  const int tiles = (n + kTile - 1) / kTile;
  const dim3 grid(batch, tiles, tiles);
  const dim3 block(kEdge, kEdge);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int j = 0; j < m; ++j) {
    lhs_level_kernel<<<grid, block, 0, s>>>(a, scales, scratch, out, coeffs,
                                            m, n, j);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// a: (B, m, n, n) stack; scales: m floats on the device; w: (B, n, bc);
// out: (B, n, bc).
int hermite_rhs_f32(const float* a, const float* scales, const float* w,
                    float* out,
                    const float* coeffs_host, int batch, int m, int n, int bc,
                    void* stream) {
  if (m < 1 || m > kMaxLevels || n < 1 || bc < 1 || batch < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Coeffs coeffs = make_coeffs(coeffs_host, m);
  // the tile ring and the padded state levels
  const size_t smem =
      (static_cast<size_t>(kRhsStages) * kTileFloats +
       static_cast<size_t>(m + 1) * round_up(n, kRhsDepth) *
           round_up(bc, kColChunk)) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rhs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  rhs_kernel<<<batch, kRhsThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      a, scales, w, out, coeffs, m, n, bc);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
