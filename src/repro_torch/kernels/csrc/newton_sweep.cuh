// The per-column scalar-Newton recurrence of the logistic kernels
// (logistic_filter_gains.cu; logistic_gains.cu takes row_loglik and
// softplus_f32 from here and keeps its own form of the Newton steps, with
// the labels staged and an approximate exponential): the role the shared
// newton_gain_sweep of src/repro/kernels/logistic_gains/kernel.py plays
// for the TPU kernels.
//
// For one state (labels y, logits η, both (d,)) and candidate column x,
// `steps` Newton iterations from w = 0 on max_w ℓ(y, η + x·w):
//
//     g = Σ_i x_i (y_i − p_i),  h = Σ_i x_i² p_i (1 − p_i),  p = σ(η + x·w)
//     w ← w + g / (h + 1e-9)
//
// then the gain Σ_i [ℓ_i(η_i + x_i w) − ℓ_i(η_i)], clamped at 0, with
// ℓ_i(u) = y_i·u − softplus(u).  Each Newton step needs its sums over all
// d rows before w can move; the caller's reducer (shared memory across
// warps, or warp shuffles) makes them, so one device function serves a
// thread that owns one column and a warp that owns a few.
//
// Numerics, all f32, built without fast math (expf, log1pf and the divide
// stay on the reference's function):
//   * σ(u) and 1 − σ(u) = σ(−u) come from one e = expf(−|u|) and one
//     exact divide r = 1/(1 + e): σ(|u|) = r, σ(−|u|) = e·r.  Neither
//     overflows for any |u|, and 1 − p keeps its digits where p ≈ 1.
//     Where p(1 − p) underflows the step g/(h + 1e-9) is large, as in the
//     reference; it is not clipped.
//   * ℓ_i(u) is taken as (y_i − 1)·u − softplus(−u) when y_i ≥ ½ and as
//     y_i·u − softplus(u) otherwise — the same function; for 0/1 labels
//     both are −softplus(∓u), the row's own log-loss, with no term of
//     order |u| to cancel.  softplus(v) = max(v, 0) + log1pf(expf(−|v|)).
//   * The gain sums per-row differences ℓ_i(z_i) − ℓ_i(η_i), where
//     ℓ_i(η_i) is made once per state and row (row_loglik_kernel) —
//     not ℓ_new − ℓ_old, two sums of order d·ln 2 whose f32 difference
//     cancels (the plain version keeps the reference's formula).
//
// Per element and Newton step: one expf, one divide (both through the
// special-function units), about 11 flops; the closing pass one expf,
// one log1pf and about 8 flops.
#pragma once

#include "stream.cuh"

namespace repro_torch {

constexpr float NEWTON_EPS = 1e-9f;

__device__ __forceinline__ float softplus_f32(float v) {
  return fmaxf(v, 0.f) + log1pf(expf(-fabsf(v)));
}

// ℓ_i(u) = y·u − softplus(u), in the form that does not cancel.
__device__ __forceinline__ float row_loglik(float u, float y) {
  return y >= 0.5f ? fmaf(y - 1.f, u, -softplus_f32(-u))
                   : fmaf(y, u, -softplus_f32(u));
}

// Adds row i's terms of g and h at logit u for candidate value x.
__device__ __forceinline__ void newton_terms(float x, float u, float y,
                                             float& g, float& h) {
  const float e = expf(-fabsf(u));
  const float r = 1.f / (1.f + e);
  const float er = e * r;
  const bool pos = u >= 0.f;
  const float p = pos ? r : er;          // σ(u)
  const float q = pos ? er : r;          // σ(−u) = 1 − σ(u)
  const float resid = y >= 0.5f ? (y - 1.f) + q : y - p;
  g = fmaf(x, resid, g);
  h = fmaf(x * x, p * q, h);
}

// gain[c] for the NC columns a thread (or the group of threads sharing
// them) works on.
//   rows(f)   calls f(x, eta, y, c_old) once for each row the thread
//             owns: x (float[NC]) the columns' values, c_old = ℓ_i(η_i);
//   reduce(v) sums v (float[N]) over the threads that share the columns
//             and leaves the totals, bit for bit the same, in all of them.
template <int NC, class Rows, class Reduce>
__device__ __forceinline__ void newton_gain_sweep(int steps, Rows&& rows,
                                                  Reduce&& reduce,
                                                  float (&gain)[NC]) {
  float w[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) w[c] = 0.f;
  for (int s = 0; s < steps; ++s) {
    float gh[2 * NC];
#pragma unroll
    for (int c = 0; c < 2 * NC; ++c) gh[c] = 0.f;
    rows([&](const float (&x)[NC], float eta, float y, float) {
#pragma unroll
      for (int c = 0; c < NC; ++c)
        newton_terms(x[c], fmaf(x[c], w[c], eta), y, gh[c], gh[NC + c]);
    });
    reduce(gh);
#pragma unroll
    for (int c = 0; c < NC; ++c) w[c] += gh[c] / (gh[NC + c] + NEWTON_EPS);
  }
  float acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) acc[c] = 0.f;
  rows([&](const float (&x)[NC], float eta, float y, float c_old) {
#pragma unroll
    for (int c = 0; c < NC; ++c)
      acc[c] += row_loglik(fmaf(x[c], w[c], eta), y) - c_old;
  });
  reduce(acc);
#pragma unroll
  for (int c = 0; c < NC; ++c) gain[c] = fmaxf(acc[c], 0.f);
}

// c[s, i] = ℓ_i(η_si) for the S states' logits etas (S, d): the old
// log-likelihood row terms, made once per state instead of once per
// candidate column.
__global__ void row_loglik_kernel(const float* __restrict__ y,
                                  const float* __restrict__ etas, int d,
                                  long long total, float* __restrict__ c) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    c[e] = row_loglik(etas[e], y[e % d]);
  }
}

static inline void launch_row_loglik(const float* y, const float* etas,
                                     int d, int S, float* c,
                                     cudaStream_t s) {
  const long long total = (long long)S * d;
  long long blocks = (total + 255) / 256;
  if (blocks > 4096) blocks = 4096;
  row_loglik_kernel<<<(int)blocks, 256, 0, s>>>(y, etas, d, total, c);
}

}  // namespace repro_torch
