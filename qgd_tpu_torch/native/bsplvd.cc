// de Boor's B-spline basis evaluation with derivatives, in C++: the
// qgd_tpu_torch copy of the JAX package's native library (the port does not
// import that package). It is an independent parity oracle for the de Boor
// control tables (qgd_tpu_torch/controls/deboor.py) and evaluates basis
// tables on the host.
//
// Implemented from the mathematical definitions (Cox-de Boor recurrence and
// the B-spline derivative recurrence), not transcribed from pppack.
//
// Built at first use by qgd_tpu_torch/native/binding.py (g++ -O3 -shared
// -fPIC), loaded with ctypes.

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Values at x of the k B-splines of order k that are non-zero on the knot
// interval [t[left], t[left+1]). Output out[j] is spline (left-k+1+j),
// j = 0..k-1 (0-based). Mirrors bsplvb semantics.
void qgd_bsplvb(const double* t, int64_t k, double x, int64_t left,
                double* out) {
  std::vector<double> deltal(k), deltar(k);
  out[0] = 1.0;
  for (int64_t j = 0; j < k - 1; ++j) {
    deltar[j] = t[left + j + 1] - x;
    deltal[j] = x - t[left - j];
    double saved = 0.0;
    for (int64_t i = 0; i <= j; ++i) {
      const double term = out[i] / (deltar[i] + deltal[j - i]);
      out[i] = saved + deltar[i] * term;
      saved = deltal[j - i] * term;
    }
    out[j + 1] = saved;
  }
}

// Values and first (nderiv-1) derivatives of the k non-vanishing order-k
// B-splines at x. Output dbiatx is column-major (k, nderiv): entry
// (i, m) = m-th derivative of spline (left-k+1+i). Mirrors bsplvd
// semantics (src/Fortran/bsplvd.f:1-112) via the derivative recurrence
//   B'_{i,k} = (k-1) [ B_{i,k-1}/(t_{i+k-1}-t_i) - B_{i+1,k-1}/(t_{i+k}-t_{i+1}) ].
void qgd_bsplvd(const double* t, int64_t k, double x, int64_t left,
                double* dbiatx, int64_t nderiv) {
  if (nderiv < 1) return;
  if (nderiv > k) nderiv = k;

  // Column 0: values of order-k splines.
  qgd_bsplvb(t, k, x, left, dbiatx);

  if (nderiv == 1) return;

  // Values of all lower-order splines needed: order k-m has k-m non-zero
  // splines at x, with global first index left-(k-m)+1.
  // lower[m] holds the (k-m) values of order-(k-m) splines.
  std::vector<std::vector<double>> lower(nderiv);
  for (int64_t m = 1; m < nderiv; ++m) {
    lower[m].resize(k - m);
    qgd_bsplvb(t, k - m, x, left, lower[m].data());
  }

  // coeff[i][j]: representation of the m-th derivative of order-k spline
  // (index i in the nonzero window) as sum_j coeff[i][j] * B_{j, k-m}
  // where j indexes the order-(k-m) nonzero window.
  // Start: m = 0, coeff = identity (k x k).
  std::vector<std::vector<double>> coeff(k, std::vector<double>(k, 0.0));
  for (int64_t i = 0; i < k; ++i) coeff[i][i] = 1.0;

  for (int64_t m = 1; m < nderiv; ++m) {
    const int64_t w = k - m;  // window size at order k-m
    // New coefficients: derivative maps B_{g,k-m+1} ->
    //   (k-m) [ B_{g,k-m}/(t[g+k-m]-t[g]) - B_{g+1,k-m}/(t[g+1+k-m]-t[g+1]) ]
    // Window of order k-m+1 starts at g0 = left-(k-m+1)+1 = left-k+m;
    // window of order k-m starts at g0+1.
    const int64_t g0 = left - k + m;  // global index of old window start
    for (int64_t i = 0; i < k; ++i) {
      std::vector<double> nc(w, 0.0);
      for (int64_t j = 0; j < w + 1; ++j) {  // old window entries
        const double c = coeff[i][j];
        if (c == 0.0) continue;
        const int64_t g = g0 + j;  // global spline index at order k-m+1
        const double dl = t[g + k - m] - t[g];
        if (dl != 0.0) {
          // B_{g,k-m} sits at local index (g - (g0+1)) = j-1 in new window
          if (j - 1 >= 0 && j - 1 < w) nc[j - 1] += (k - m) * c / dl;
        }
        const double dr = t[g + 1 + k - m] - t[g + 1];
        if (dr != 0.0) {
          if (j >= 0 && j < w) nc[j] -= (k - m) * c / dr;
        }
      }
      coeff[i].assign(nc.begin(), nc.end());
      coeff[i].resize(k, 0.0);
      // contract with order-(k-m) values
      double val = 0.0;
      for (int64_t j = 0; j < w; ++j) val += nc[j] * lower[m][j];
      dbiatx[m * k + i] = val;
    }
  }
}

// Batched helper: evaluate the full scaled-derivative tables for a clamped
// uniform B-spline control over a time grid — the setup-time hot path.
// knots: padded knot vector (n_knots), order k, n_distinct distinct knots,
// xs: (n_x) points in [0,1], nderiv derivative orders.
// out: (n_x, nderiv, k) row-major values; out_offsets: (n_x) first
// coefficient index per point.
void qgd_bspline_tables(const double* knots, int64_t k, int64_t n_distinct,
                        const double* xs, int64_t n_x, int64_t nderiv,
                        double* out, int64_t* out_offsets) {
  std::vector<double> dbiatx(k * nderiv);
  for (int64_t ix = 0; ix < n_x; ++ix) {
    const double x = xs[ix];
    int64_t l_dist = static_cast<int64_t>(x * (n_distinct - 1));
    if (l_dist < 0) l_dist = 0;
    if (l_dist > n_distinct - 2) l_dist = n_distinct - 2;
    const int64_t left = (k - 1) + l_dist;
    qgd_bsplvd(knots, k, x, left, dbiatx.data(), nderiv);
    out_offsets[ix] = l_dist;
    for (int64_t m = 0; m < nderiv; ++m)
      for (int64_t i = 0; i < k; ++i)
        out[(ix * nderiv + m) * k + i] = dbiatx[m * k + i];
  }
}

}  // extern "C"
