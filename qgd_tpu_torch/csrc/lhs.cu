// Entry point of the LHS kernels (csrc/lhs.cuh): hermite_lhs_matrix_f32
// replaces the Pallas kernel qgd_tpu/ops/pallas_step.py:184
// hermite_lhs_matrix_kernel_call. Plain C interface (no PyTorch headers),
// loaded with ctypes; it launches on the given stream, allocates nothing,
// and returns cudaGetLastError() (or kShapeRefused) so a refused launch is
// reported.

#include "lhs.cuh"

extern "C" {

// a: (B, m, n, n) stack; dt: one float on the device, or null to use
// dt_value; the step scales are (sign*dt)^(k+1); scratch: (B, m-2, n, n)
// when m >= 3 (unused otherwise); out: (B, n, n); coeffs_host: m+1 floats.
int hermite_lhs_matrix_f32(const float* a, const float* dt, float dt_value,
                           float sign, float* scratch, float* out,
                           const float* coeffs_host, int batch, int m, int n,
                           void* stream) {
  return launch_stage<false>(a, dt, dt_value, sign, scratch, out, nullptr,
                             coeffs_host, batch, m, n, stream);
}

}  // extern "C"
