// Entry point of the pair kernels: hermite_stage_pair_f32 builds the
// backward's (R, L) from one recursion, the counterpart of the JAX
// package's XLA function qgd_tpu/forward.py:158 _stage_matrices_both. At
// m = 2 with n <= 128, n % 4 == 0 and an aligned stack it launches the
// split-TF32 tensor-core kernel (pair_tf32.cuh); every other shape takes
// csrc/lhs.cuh instantiated with kPair (the staged launch writing D_2 to
// scratch, then one level launch per j >= 2). Plain C interface, as lhs.cu.

#include "lhs.cuh"
#include "pair_tf32.cuh"

extern "C" {

// The pair (R, L) of one recursion on the stack scaled at s = +dt: out_r
// gets sum_j c_j D_j, out_l sum_j (-1)^j c_j D_j, each (B, n, n); the other
// arguments as hermite_lhs_matrix_f32's (lhs.cu).
int hermite_stage_pair_f32(const float* a, const float* dt, float dt_value,
                           float* scratch, float* out_r, float* out_l,
                           const float* coeffs_host, int batch, int m, int n,
                           void* stream) {
  if (pair_tf32_takes(a, batch, m, n))
    return launch_pair_tf32(a, dt, dt_value, out_r, out_l, coeffs_host,
                            batch, n, stream);
  return launch_stage<true>(a, dt, dt_value, 1.0f, scratch, out_r, out_l,
                            coeffs_host, batch, m, n, stream);
}

}  // extern "C"
