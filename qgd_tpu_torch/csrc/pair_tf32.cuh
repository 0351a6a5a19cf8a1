// Hopper (sm_90a) kernel for the backward's pair of one-step matrices at
// m = 2 (order 4) on the tensor cores, in split TF32:
// hermite_stage_pair_f32 (pair.cu) launches it for every (B, 2, n, n)
// float32 stack with n <= 128, n % 4 == 0 and 16-byte alignment. At those
// shapes it replaces the FP32-FMA pair variant of the staged LHS kernel
// (lhs_staged_kernel<kFull, true>, lhs.cuh), which the pair keeps at
// m >= 3; it is the counterpart of the JAX package's XLA function
// qgd_tpu/forward.py:158 _stage_matrices_both.
//
// What it computes, for each of the B stacks At_k = dt^(k+1) A_k (k < 2;
// the recursion runs at sign +1):
//   R = c_0 I + c_1 At_0 + c_2 D_2,  L = c_0 I - c_1 At_0 + c_2 D_2,
//   D_2 = (At_1 + At_0 At_0) / 2.
// No structure of the stack (the real-stacked [[S, K], [-K, S]] blocks)
// is assumed.
//
// What bounds it on the card: at the main-path shape (B = 256, n = 128)
// it must move 67.1 MB (the 33.6 MB stack read once, the two 16.8 MB
// outputs written once): 20.0 us at 3.35 TB/s. Its one 128^3 product per
// matrix, 1.074 GFLOP, takes 16.0 us at the 67 TFLOP/s FP32 FMA peak, and
// an FMA loop reaches about a third of that peak, so in FP32 FMA the
// product and not the bytes sets the pace. On the tensor cores the same
// product costs three TF32 passes, 3.2 GFLOP, 6.5 us at 495 TFLOP/s: the
// design moves the product there and keeps the bytes as the bound.
//  * Split TF32, float32 accuracy: each operand x, scaled by its step
//    scale first (in registers, the same f32 rounding as a scaled copy),
//    splits into hi = tf32(x), rounded to nearest with ties away
//    (cvt.rna.tf32.f32's rounding, as an integer add and mask: cvt.rna
//    compiles to a longer sequence), and lo = x - hi cut to TF32 (one
//    mask: a second rounding on the half-rate integer pipe slowed the
//    kernel at large B and did not lower its error against float64),
//    together 21-22 bits of x. Each 8-deep k-step accumulates
//    lo*hi, then hi*lo, then hi*hi (mma.sync m16n8k8 tf32); the dropped
//    lo*lo is below f32 rounding of the product. The
//    12 products of a 32-deep chunk go into zeroed accumulators that are
//    then added into the running sum in float32, round to nearest: summed
//    by the tensor cores over all 48 products, the pair's error against
//    float64 was twice the float32 kernel's on random stacks; chunked, it
//    is below it. No single-pass TF32 product is formed.
//  * Output tiles spread over blocks: a block of 4 warps (2 x 2, each a
//    32 x 32 or 16 x 16 warp tile) owns a kT x kT tile of both outputs,
//    kT = 64 (four blocks per matrix at n = 128) or, where B * 4 blocks
//    would fill under three quarters of the SMs (B <= 24 at n = 128 on
//    132 SMs), kT = 32 (sixteen): timed on an H100 at n = 128
//    (tools/pair_tile_variants.py), the 32-tiles win up to B = 24 (1.7x
//    at B = 1) and lose from B = 28 on. Three 64-tile blocks fit an SM,
//    so one block's loads overlap another's products and stores; the
//    blocks of one matrix are adjacent in the grid and share its strips
//    through L2. At n = 128 the body is compiled for that size (kFull):
//    without bounds checks and zero fill it takes 4-29 % less time at
//    every batch and tile timed (B = 256, 64-tiles: 0.0352 against
//    0.0399 ms).
//  * A block stages its row strip (At_0 rows r0.., every k) and its column
//    strip (every k, columns c0..) in shared memory by 16-byte cp.async,
//    in four groups by the 32-deep k-chunk that first needs them, so the
//    products of chunk 0 start while chunks 1-3 arrive. The MMA's k-slots
//    t and t + 4 take k = 2t and 2t + 1 of each step in both operands, so
//    an A fragment's row is one 8-byte load; a row-strip pitch of 8 and a
//    column-strip pitch of 4 floats past a multiple of 32 keep every
//    fragment load conflict-free. Where n < 128 the strips are zero-filled
//    to a multiple of 8 in k and to the tile's edge.
//  * At_1 (the i = 0 term) is never staged: its tile's rows are asked into
//    L2 when the block starts (one bulk prefetch a row) and read in the
//    epilogue, whole rows at a time. Read into the accumulators in the
//    MMA's C-fragment layout while At_0 arrived (32 bytes of a row per
//    request), it slowed the kernel's data movement markedly.
//  * The epilogue passes the products through shared memory (the column
//    strip's place), so that 16 lanes cover a 256-byte row: it reads At_1,
//    forms R and L with the staged At_0 in registers, and writes each
//    element once, 16 bytes a store (st.global.cg: the compiler split a
//    plain float4 store here into four 4-byte stores, which halved the
//    kernel's speed).
//  * What holds it back: the blocks' phases (strips in, products, rows
//    out) overlap on an SM only in part. Its data movement alone is a
//    little slower than a plain copy of the same bytes, and its
//    instructions alone (half of them the splits, each operand split by
//    the two warps that share it) take about as long as that copy. A
//    wgmma variant (A split in registers, the column strip split once into
//    K-major hi and lo copies, two blocks an SM), Veltkamp splits in
//    floating point, and a persistent variant that prefetched the next
//    tile into L2 were all slower.

#pragma once

#include <cstdint>

#include "stage_common.cuh"

namespace {
namespace tf32_pair {

constexpr int kDim = 128;       // largest n
constexpr int kThreads = 128;   // 4 warps, 2 x 2 over the tile
constexpr int kChunk = 32;      // k-depth of one copy group
constexpr int kALd = kDim + 8;  // row-strip pitch (floats): 8 mod 32

template <int kT>
struct Tile {
  static constexpr int kBLd = kT + 4;      // column-strip pitch: 4 mod 32
  static constexpr int kWarp = kT / 2;     // a warp's kWarp x kWarp
  static constexpr int kMT = kWarp / 16;   // its m16 fragments
  static constexpr int kNT = kWarp / 8;    // its n8 fragments
  // 16-byte copies of a thread per strip and k-chunk
  static constexpr int kCopies = kT / 16;
  static constexpr int kSmem = (kT * kALd + kDim * kBLd) * sizeof(float);
  static constexpr int kMinBlocks = kT == 64 ? 3 : 4;
};

// x = hi + lo + (below 2^-21 |x|), hi and lo TF32 values as float bits
// with the low 13 clear: hi rounded to nearest with ties away from zero
// (cvt.rna.tf32.f32's rounding for every finite x), lo = x - hi (exact)
// cut to TF32 toward zero
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

// d += a b, one 16 x 8 x 8 TF32 product with float32 accumulators
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Visit this thread's 16-byte slots of k-chunk c: fn(false, row, k) in the
// row strip (row local to the tile), fn(true, k, column) in the column
// strip (column local to the tile).
template <int kT, typename F>
__device__ __forceinline__ void for_copies(int c, int tid, F&& fn) {
#pragma unroll
  for (int q = 0; q < Tile<kT>::kCopies; ++q) {
    const int i = tid + kThreads * q;
    fn(false, i >> 3, kChunk * c + 4 * (i & 7));
    fn(true, kChunk * c + i / (kT / 4), 4 * (i % (kT / 4)));
  }
}

// kFull: n = 128 (the main path), the size known at compile time.
template <int kT, bool kFull>
__global__ void __launch_bounds__(kThreads, Tile<kT>::kMinBlocks)
stage_pair_tf32_kernel(const float* __restrict__ a, const float* dt_dev,
                       float dt_value, float* __restrict__ out_r,
                       float* __restrict__ out_l, hermite::Coeffs coeffs,
                       int n_arg) {
  using T = Tile<kT>;
  extern __shared__ __align__(16) float smem[];
  float* sA = smem;              // At_0 rows r0 .. r0+kT-1, kT x kALd
  float* sB = smem + kT * kALd;  // At_0 columns c0 .. c0+kT-1, kDim x kBLd
  const int n = kFull ? kDim : n_arg;
  const int tiles = (n + kT - 1) / kT;
  const int b = blockIdx.x / (tiles * tiles);
  const int tile = blockIdx.x - b * tiles * tiles;
  const int r0 = tile / tiles * kT;
  const int c0 = tile % tiles * kT;
  const int tid = threadIdx.x;
  const size_t nn = static_cast<size_t>(n) * n;
  const float* a0 = a + static_cast<size_t>(b) * 2 * nn;
  const float* a1 = a0 + nn;
  const int kpad = kFull ? kDim : hermite::round_up(n, 8);
  const int nchunks = (kpad + kChunk - 1) / kChunk;

  // At_1's tile is read in the epilogue: its rows are asked into L2 now
  if (tid < kT && (kFull || r0 + tid < n))
    hermite::prefetch_l2(a1 + static_cast<size_t>(r0 + tid) * n + c0,
                         (kFull ? kT : min(kT, n - c0)) * sizeof(float));

  // the shared slot of one 16-byte copy
  auto slot = [&](bool col_strip, int r, int c) {
    return col_strip ? sB + r * T::kBLd + c : sA + r * kALd + c;
  };
#pragma unroll
  for (int c = 0; c < nchunks; ++c) {
    for_copies<kT>(c, tid, [&](bool col_strip, int r, int col) {
      const int gr = col_strip ? r : r0 + r;
      const int gc = col_strip ? c0 + col : col;
      const float* src = a0 + static_cast<size_t>(gr) * n + gc;
      if (kFull) {
        hermite::cp_async16(slot(col_strip, r, col), src);
      } else {
        const bool inside = gr < n && gc < n;
        hermite::cp_async16_zfill(slot(col_strip, r, col), inside ? src : a,
                                  inside ? 16 : 0);
      }
    });
    hermite::cp_async_commit();
  }

  const float s = hermite::step_base(dt_dev, dt_value, 1.0f);
  const float scale0 = hermite::step_scale(s, 0);
  const float scale1 = hermite::step_scale(s, 1);

  // lane (g, t) of warp (wr, wc): C-fragment rows g, g + 8 and columns
  // 2t, 2t + 1 of each 16 x 8 fragment
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wr = (warp >> 1) * T::kWarp;
  const int wc = (warp & 1) * T::kWarp;

  // acc: At_0 At_0, summed chunk by chunk
  float acc[T::kMT][T::kNT][4] = {};

  // The MMA's k-slots t and t + 4 take k = 2t and 2t + 1 of each 8-deep
  // step, in both operands: an A fragment's row is one 8-byte load. A
  // fragment (16 x 8): rows g, g + 8; B fragment (8 x 8): column g.
  const float* a_frag = sA + (wr + g) * kALd + 2 * t;
  const float* b_frag = sB + 2 * t * T::kBLd + wc + g;
#pragma unroll
  for (int c = 0; c < nchunks; ++c) {
    hermite::cp_async_wait(nchunks - 1 - c);
    __syncthreads();  // chunk c's strips are in place
    // one chunk's 12 products per fragment on the tensor cores, then into
    // acc in float32 (round to nearest)
    float part[T::kMT][T::kNT][4] = {};
    const int k_end = kFull ? kChunk * (c + 1) : min(kpad, kChunk * (c + 1));
#pragma unroll
    for (int k = kChunk * c; k < k_end; k += 8) {
      uint32_t ah[T::kMT][4], al[T::kMT][4], bh[T::kNT][2], bl[T::kNT][2];
#pragma unroll
      for (int mt = 0; mt < T::kMT; ++mt) {
        const float2 x0 = *reinterpret_cast<const float2*>(
            a_frag + 16 * mt * kALd + k);
        const float2 x1 = *reinterpret_cast<const float2*>(
            a_frag + (16 * mt + 8) * kALd + k);
        split(x0.x * scale0, ah[mt][0], al[mt][0]);
        split(x1.x * scale0, ah[mt][1], al[mt][1]);
        split(x0.y * scale0, ah[mt][2], al[mt][2]);
        split(x1.y * scale0, ah[mt][3], al[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < T::kNT; ++nt) {
        const float* p = b_frag + k * T::kBLd + 8 * nt;
        split(p[0] * scale0, bh[nt][0], bl[nt][0]);
        split(p[T::kBLd] * scale0, bh[nt][1], bl[nt][1]);
      }
      // the small terms first
#pragma unroll
      for (int mt = 0; mt < T::kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < T::kNT; ++nt) mma(part[mt][nt], al[mt], bh[nt]);
#pragma unroll
      for (int mt = 0; mt < T::kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < T::kNT; ++nt) mma(part[mt][nt], ah[mt], bl[nt]);
#pragma unroll
      for (int mt = 0; mt < T::kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < T::kNT; ++nt) mma(part[mt][nt], ah[mt], bh[nt]);
    }
#pragma unroll
    for (int mt = 0; mt < T::kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < T::kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] += part[mt][nt][e];
  }

  // The products go through shared memory (the column strip's place, free
  // once every warp is past its last k-step), so that the epilogue reads
  // At_1 and writes R and L in runs of whole tile rows, 16 bytes a lane:
  // thread runs tid + 128 i, each 4 columns of one row.
  constexpr int kDLd = kT + 8;                     // 8 mod 32
  constexpr int kRuns = kT * kT / 4 / kThreads;   // 8, or 2 at kT = 32
  auto run = [&](int i, int& rl, int& cl) {
    const int e = tid + kThreads * i;
    rl = e / (kT / 4);
    cl = 4 * (e % (kT / 4));
    return kFull || (r0 + rl < n && c0 + cl < n);
  };
  float4 v1[kRuns];
#pragma unroll
  for (int i = 0; i < kRuns; ++i) {
    int rl, cl;
    v1[i] = run(i, rl, cl)
                ? __ldcg(reinterpret_cast<const float4*>(
                      a1 + static_cast<size_t>(r0 + rl) * n + c0 + cl))
                : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();
  float* sD = sB;  // kT x kDLd
#pragma unroll
  for (int mt = 0; mt < T::kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < T::kNT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(
            sD + (wr + 16 * mt + g + 8 * h) * kDLd + wc + 8 * nt + 2 * t) =
            make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
  __syncthreads();

  // R = c_0 I + c_1 D_1 + c_2 D_2, L = c_0 I - c_1 D_1 + c_2 D_2, with
  // D_1 = At_0 (staged, scaled here) and D_2 = (At_1 + At_0 At_0) / 2
  const float w0 = coeffs.c[0];
  const float w1 = coeffs.c[1];
  const float w2 = coeffs.c[2];
  float* out_rb = out_r + static_cast<size_t>(b) * nn;
  float* out_lb = out_l + static_cast<size_t>(b) * nn;
#pragma unroll
  for (int i = 0; i < kRuns; ++i) {
    int rl, cl;
    if (!run(i, rl, cl)) continue;
    const int r = r0 + rl;
    const int col = c0 + cl;
    const float4 vp = *reinterpret_cast<const float4*>(sD + rl * kDLd + cl);
    const float4 v0 = *reinterpret_cast<const float4*>(sA + rl * kALd + col);
    const float at1[4] = {v1[i].x, v1[i].y, v1[i].z, v1[i].w};
    const float prod[4] = {vp.x, vp.y, vp.z, vp.w};
    const float d1[4] = {v0.x * scale0, v0.y * scale0, v0.z * scale0,
                         v0.w * scale0};
    float o[4], o2[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float d = (at1[e] * scale1 + prod[e]) / 2.0f;
      const float eye = w0 * (r == col + e ? 1.0f : 0.0f);
      o[e] = (eye + w1 * d1[e]) + w2 * d;
      o2[e] = (eye - w1 * d1[e]) + w2 * d;
    }
    const size_t idx = static_cast<size_t>(r) * n + col;
    __stcg(reinterpret_cast<float4*>(out_rb + idx),
           make_float4(o[0], o[1], o[2], o[3]));
    __stcg(reinterpret_cast<float4*>(out_lb + idx),
           make_float4(o2[0], o2[1], o2[2], o2[3]));
  }
}

template <int kT, bool kFull>
cudaError_t launch(const float* a, const float* dt, float dt_value,
                   float* out_r, float* out_l, const hermite::Coeffs& coeffs,
                   int batch, int n, cudaStream_t st) {
  static unsigned smem_set = 0;
  const cudaError_t err = hermite::allow_full_smem(
      reinterpret_cast<const void*>(stage_pair_tf32_kernel<kT, kFull>),
      &smem_set);
  if (err != cudaSuccess) return err;
  const int tiles = (n + kT - 1) / kT;
  const long long blocks = static_cast<long long>(batch) * tiles * tiles;
  stage_pair_tf32_kernel<kT, kFull>
      <<<static_cast<unsigned>(blocks), kThreads, Tile<kT>::kSmem, st>>>(
          a, dt, dt_value, out_r, out_l, coeffs, n);
  return cudaGetLastError();
}

}  // namespace tf32_pair

// Whether the split-TF32 kernel takes the stack (B, m, n, n) at `a`.
inline bool pair_tf32_takes(const float* a, int batch, int m, int n) {
  return m == 2 && batch >= 1 && n >= 4 && n <= tf32_pair::kDim &&
         n % 4 == 0 && reinterpret_cast<std::uintptr_t>(a) % 16 == 0;
}

// One launch over the B stacks: 64 x 64 output tiles, or 32 x 32 where
// the 64-tiles would give fewer blocks than three quarters of the SMs.
int launch_pair_tf32(const float* a, const float* dt, float dt_value,
                     float* out_r, float* out_l, const float* coeffs_host,
                     int batch, int n, void* stream) {
  using namespace tf32_pair;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long t64 = (n + 63) / 64;
  const bool wide = 4 * static_cast<long long>(batch) * t64 * t64 >= 3 * sms;
  const long long t32 = (n + 31) / 32;
  if (static_cast<long long>(batch) * (wide ? t64 * t64 : t32 * t32) >
      0x7fffffffLL)
    return hermite::kShapeRefused;
  const hermite::Coeffs coeffs = hermite::make_coeffs(coeffs_host, 2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n == kDim)
    err = wide ? launch<64, true>(a, dt, dt_value, out_r, out_l, coeffs,
                                  batch, n, st)
               : launch<32, true>(a, dt, dt_value, out_r, out_l, coeffs,
                                  batch, n, st);
  else
    err = wide ? launch<64, false>(a, dt, dt_value, out_r, out_l, coeffs,
                                   batch, n, st)
               : launch<32, false>(a, dt, dt_value, out_r, out_l, coeffs,
                                   batch, n, st);
  return static_cast<int>(err);
}

}  // namespace
