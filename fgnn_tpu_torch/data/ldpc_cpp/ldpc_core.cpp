// ldpc_core.cpp: native LDPC numerics for the fgnn_tpu_torch data layer
// (the port's copy of fgnn_tpu/data/ldpc_cpp/ldpc_core.cpp).
//
// The host-side hot loops of LDPC sample generation, with a plain C ABI
// (loaded with ctypes):
//
//   * sum-product (belief-network) decoding of A x = z given bit priors,
//     MacKay's algorithm: leave-one-out products via forward/backward
//     partial products, clip 0.9999999999, underflow guard 1e-40, early
//     stop on syndrome match (numpy oracle: data/bp_ref.py, same bits)
//   * GF(2) block encode t = G s
//   * a batched decoder entry point (a simple loop over the words) for the
//     dataset writers.
//
// The graph is passed as padded index arrays built in Python from the alist
// file (data/bp_ref.py, BPGraph).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 ldpc_core.cpp -o libldpc_core.so

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr double kClip = 0.9999999999;
constexpr double kTiny = 1e-40;

struct Graph {
  int N, M, max_rd, max_cd;
  const int32_t* row_cols;  // (M, max_rd), -1 padded
  const int32_t* col_rows;  // (N, max_cd), -1 padded
  const int32_t* col_slot;  // (N, max_cd): slot of var n within row m's list
};

// Decode one word. bias[n] = P(x_n = 1); target syndrome z (may be null ->
// all-zero). Returns number of unsatisfied checks (0 == success).
int decode_one(const Graph& g, const double* bias, const uint8_t* z,
               int max_loops, uint8_t* x_out, int* iters_out) {
  const int N = g.N, M = g.M, rd = g.max_rd, cd = g.max_cd;

  // Messages stored check-side: dqc[m * rd + l].
  std::vector<double> dqc(static_cast<size_t>(M) * rd, 1.0);
  std::vector<double> pc0(static_cast<size_t>(M) * rd, 1.0);
  std::vector<double> pc1(static_cast<size_t>(M) * rd, 1.0);
  std::vector<double> fwd(rd + 1), bwd(rd + 2);
  std::vector<double> q1(N, 0.49);
  std::vector<uint8_t> x(N, 0), syn(M, 0);

  for (int m = 0; m < M; ++m)
    for (int l = 0; l < rd; ++l) {
      int n = g.row_cols[m * rd + l];
      dqc[m * rd + l] = (n >= 0) ? (1.0 - 2.0 * bias[n]) : 1.0;
    }

  int viol = M;
  int it = 0;
  for (it = 1; it <= max_loops; ++it) {
    // ---- check (horizontal) pass ----
    for (int m = 0; m < M; ++m) {
      int deg = 0;
      while (deg < rd && g.row_cols[m * rd + deg] >= 0) ++deg;
      fwd[0] = 1.0;
      for (int l = 0; l < deg; ++l) fwd[l + 1] = fwd[l] * dqc[m * rd + l];
      bwd[deg] = 1.0;
      for (int l = deg - 1; l >= 0; --l) bwd[l] = bwd[l + 1] * dqc[m * rd + l];
      const double sign = (z && z[m]) ? -1.0 : 1.0;
      for (int l = 0; l < deg; ++l) {
        double dpc = 0.5 * fwd[l] * bwd[l + 1] * sign;
        pc0[m * rd + l] = 0.5 + dpc;
        pc1[m * rd + l] = 0.5 - dpc;
      }
    }

    // ---- variable (vertical) pass ----
    for (int n = 0; n < N; ++n) {
      int deg = 0;
      while (deg < cd && g.col_rows[n * cd + deg] >= 0) ++deg;
      // forward/backward products of pc0/pc1 down the column
      double f0[16], f1[16], b0[16], b1[16];  // max_cd <= 15 in practice
      f0[0] = 1.0 - bias[n];
      f1[0] = bias[n];
      for (int u = 0; u < deg; ++u) {
        int m = g.col_rows[n * cd + u];
        int l = g.col_slot[n * cd + u];
        f0[u + 1] = f0[u] * pc0[m * rd + l];
        f1[u + 1] = f1[u] * pc1[m * rd + l];
      }
      b0[deg] = 1.0;
      b1[deg] = 1.0;
      for (int u = deg - 1; u >= 0; --u) {
        int m = g.col_rows[n * cd + u];
        int l = g.col_slot[n * cd + u];
        b0[u] = b0[u + 1] * pc0[m * rd + l];
        b1[u] = b1[u + 1] * pc1[m * rd + l];
      }
      double tot = f0[deg] + f1[deg];
      if (tot > kTiny) q1[n] = f1[deg] / tot;  // else: leave as it was

      for (int u = 0; u < deg; ++u) {
        int m = g.col_rows[n * cd + u];
        int l = g.col_slot[n * cd + u];
        double qc0 = f0[u] * b0[u + 1];
        double qc1 = f1[u] * b1[u + 1];
        double s = qc0 + qc1;
        double d;
        if (s > kTiny) {
          d = (qc0 - qc1) / s;
          if (d > kClip) d = kClip;
          if (d < -kClip) d = -kClip;
        } else {
          d = 0.0;
        }
        dqc[m * rd + l] = d;
      }
    }

    // ---- score + early stop ----
    for (int n = 0; n < N; ++n) x[n] = q1[n] >= 0.5 ? 1 : 0;
    viol = 0;
    for (int m = 0; m < M; ++m) {
      int acc = 0;
      for (int l = 0; l < rd; ++l) {
        int n = g.row_cols[m * rd + l];
        if (n >= 0) acc ^= x[n];
      }
      uint8_t target = z ? z[m] : 0;
      if (acc != target) ++viol;
    }
    if (viol == 0) break;
  }

  std::memcpy(x_out, x.data(), N);
  if (iters_out) *iters_out = it > max_loops ? max_loops : it;
  return viol;
}

}  // namespace

extern "C" {

// Decode a batch of B words. bias: (B, N). x_out: (B, N). viols_out/iters_out: (B,).
int ldpc_bp_decode_batch(int N, int M, int max_rd, int max_cd,
                         const int32_t* row_cols, const int32_t* col_rows,
                         const int32_t* col_slot, const double* bias,
                         const uint8_t* z, int B, int max_loops,
                         uint8_t* x_out, int32_t* viols_out,
                         int32_t* iters_out) {
  if (max_cd > 15) return -1;  // stack buffers in decode_one
  Graph g{N, M, max_rd, max_cd, row_cols, col_rows, col_slot};
  for (int b = 0; b < B; ++b) {
    int iters = 0;
    int viol = decode_one(g, bias + static_cast<size_t>(b) * N,
                          z ? z + static_cast<size_t>(b) * M : nullptr,
                          max_loops, x_out + static_cast<size_t>(b) * N, &iters);
    if (viols_out) viols_out[b] = viol;
    if (iters_out) iters_out[b] = iters;
  }
  return 0;
}

// GF(2) encode: t = G s for a batch. G: (N, K) dense 0/1 bytes (row-major),
// s: (B, K), t_out: (B, N).
void ldpc_encode_batch(int K, int N, const uint8_t* G, const uint8_t* s,
                       int B, uint8_t* t_out) {
  for (int b = 0; b < B; ++b) {
    const uint8_t* sb = s + static_cast<size_t>(b) * K;
    uint8_t* tb = t_out + static_cast<size_t>(b) * N;
    for (int i = 0; i < N; ++i) {
      int acc = 0;
      const uint8_t* gi = G + static_cast<size_t>(i) * K;
      for (int k = 0; k < K; ++k) acc ^= (gi[k] & sb[k]);
      tb[i] = static_cast<uint8_t>(acc & 1);
    }
  }
}

}  // extern "C"
