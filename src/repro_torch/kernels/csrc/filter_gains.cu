// filter_gains — the sample-batched filter engine with its regression
// epilogue, hand-written for sm_90a.
//
// Replaces the TPU kernels src/repro/kernels/filter_gains/core.py
// (launch_filter_engine, the shared launch geometry) and
// src/repro/kernels/filter_gains/kernel.py (filter_gains_pallas, epilogue
// _regression_epilogue).  For every guess g < G and sample i < m of the
// DASH (OPT, α) lattice, with s = g·m + i:
//
//     gain[s, a] = (x_aᵀ r_s)² / (‖x_a‖² − ‖Q_gᵀ x_a‖² − ‖D_sᵀ x_a‖²)
//
// span-guarded like the singleton sweep.  Two launches on one stream:
//
//   1. base pass, grid (G, n/64): base[g, a] = ‖Q_gᵀ x_a‖², once per
//      (candidate block, guess) — the shared-base term the TPU design
//      cached in VMEM scratch at each guess's sample 0.  On Hopper CTAs
//      run in no order and nothing carries between them, so the term is
//      its own pass into a (G, n) scratch the wrapper allocates.
//   2. sample pass, grid (G·m, n/256): per (guess, sample) lane, c = r_sᵀx
//      and the b delta projections, then the guarded ratio reading base.
//
// What bounds it on the H100: f32 arithmetic, 2·d·n·(G·k + G·m·(b+1))
// flops — at d = n = 8192, G = 6, m = 8, k = 128, b = 10 about 174 GFLOP,
// ~2.6 ms at the 67 TFLOP/s non-tensor f32 peak.  What the design does:
// the FMA micro-tiles of proj_gain.cuh, a narrow 16-row basis tile for the
// small per-sample deltas (b ≤ 16 in one pass) and a 128-row tile for Q, and a
// lane-minor grid so the G·m CTAs of one column panel share it in L2.
//
// Known cost for the later redesign: X is read once per lane — G times in
// the base pass and G·m times in the sample pass — served partly from L2.
// The TPU design's point was ONE read of X per launch (X block resident in
// VMEM across all G·m states); at d = 8192 even 8 columns of X (256 KB)
// exceed the 227 KB of shared memory a block may use, so that needs a
// d-split with a cross-CTA reduction, which is not done here.
#include "proj_gain.cuh"

using namespace repro_torch;

constexpr int FG_BASE_BN = 64;
constexpr int FG_BASE_KT = 128;
constexpr int FG_SAMPLE_BN = 256;
constexpr int FG_SAMPLE_KT = 16;

template <typename T>
static void launch_filter(const void* X, int d, int n, int G, int m,
                          const void* Q, int k, const void* D, int b,
                          const void* R, const void* col_sq, void* base,
                          void* out, float span_tol, cudaStream_t s) {
  launch_proj_gain<T, FG_BASE_BN, FG_BASE_KT, false, false>(
      X, d, n, G, Q, k, (long long)d * k, nullptr, 0, nullptr, nullptr, 1,
      base, span_tol, s);
  launch_proj_gain<T, FG_SAMPLE_BN, FG_SAMPLE_KT, true, true>(
      X, d, n, G * m, D, b, (long long)d * b, R, d, col_sq, base, m, out,
      span_tol, s);
}

// X: (d, n) f32 or bf16 (x_bf16 != 0); Q: (G, d, k); D: (G, m, d, b);
// R: (G, m, d); col_sq: (n,); base: (G, n) scratch; out: (G, m, n).  All
// f32 except X, contiguous, on the card.
extern "C" int filter_gains_launch(const void* X, int x_bf16, int d, int n,
                                   int G, int m, const void* Q, int k,
                                   const void* D, int b, const void* R,
                                   const void* col_sq, void* base, void* out,
                                   float span_tol, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    launch_filter<__nv_bfloat16>(X, d, n, G, m, Q, k, D, b, R, col_sq, base,
                                 out, span_tol, s);
  } else {
    launch_filter<float>(X, d, n, G, m, Q, k, D, b, R, col_sq, base, out,
                         span_tol, s);
  }
  return static_cast<int>(cudaGetLastError());
}
