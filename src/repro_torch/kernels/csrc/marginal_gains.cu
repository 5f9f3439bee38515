// regression_gains — the singleton-gain sweep, hand-written for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/marginal_gains/kernel.py
// (regression_gains_pallas, body _gains_kernel).  Per lane g and candidate
// column a of X (d, n):
//
//     c = x_aᵀ r_g,  s = ‖Q_gᵀ x_a‖²,  gain = c² / (‖x_a‖² − s)
//
// span-guarded (0 when ‖x_a‖² − s ≤ span_tol·max(‖x_a‖², 1)).  The lane
// axis G carries the DASH guess lattice (one launch serves every guess's
// current-state gain); greedy and top-k call it with G = 1.
//
// What bounds it on the H100: f32 arithmetic.  One call is 2·d·n·(k+1)
// flops over d·n elements of X — at d = n = 8192, k = 128 about 17.3
// GFLOP against 268 MB, i.e. ~0.26 ms at the 67 TFLOP/s non-tensor f32
// peak versus ~0.08 ms for the bytes.  The design therefore keeps each X
// element in a register against 8 basis vectors and each basis element
// against 4 columns (a 4 × 8 FMA micro-tile per thread, operands staged
// in shared memory; see proj_gain.cuh).  It reads X once when k < 128 and
// once per 128 basis columns above that.  Tensor cores are not used: TF32
// would break parity with the f32 reference; a faster design is later work.
#include "proj_gain.cuh"

using namespace repro_torch;

constexpr int MG_BN = 64;
constexpr int MG_KT = 128;

// X: (d, n) f32 or bf16 (x_bf16 != 0); Q: (G, d, k) f32; R: (G, d) f32;
// col_sq: (n,) f32; out: (G, n) f32.  All contiguous, on the card.
extern "C" int regression_gains_launch(const void* X, int x_bf16, int d,
                                       int n, int G, const void* Q, int k,
                                       const void* R, const void* col_sq,
                                       void* out, float span_tol,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long q_stride = (long long)d * k;
  if (x_bf16) {
    launch_proj_gain<__nv_bfloat16, MG_BN, MG_KT, true, true>(
        X, d, n, G, Q, k, q_stride, R, d, col_sq, nullptr, 1, out, span_tol,
        s);
  } else {
    launch_proj_gain<float, MG_BN, MG_KT, true, true>(
        X, d, n, G, Q, k, q_stride, R, d, col_sq, nullptr, 1, out, span_tol,
        s);
  }
  return static_cast<int>(cudaGetLastError());
}
