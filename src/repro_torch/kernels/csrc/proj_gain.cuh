// Column-panel projection with a fused gain epilogue — the one CUDA
// kernel template behind both of the port's regression kernels.
//
// For a lane L (a guess, or a (guess, sample) perturbed state) and a block
// of BN candidate columns x_a of X (d, n), one CTA computes
//
//     s_a = ‖B_Lᵀ x_a‖²          B_L: (d, kb) row-major, lane-strided
//     c_a = r_Lᵀ x_a             r_L: (d,)      (HAS_R only)
//
// and either writes s (GAIN = false: the per-guess shared-base term of the
// filter engine) or the span-guarded gain (GAIN = true)
//
//     denom = (col_sq_a − base[L / lanes_per_base, a]) − s_a
//     out   = denom > span_tol·max(col_sq_a, 1) ? c_a² / max(denom, 1e-30) : 0
//
// (base is null for the singleton sweep, where denom = col_sq − s).
//
// Design: plain f32 FMA on the CUDA cores, no tensor cores (TF32 would
// break the 2e-4 parity with the f32 reference).  The CTA loops over d in
// TD-row tiles, staging the X tile (TD × BN, upcast to f32 on load) and
// the matching B rows (TD × KT) and r entries in shared memory; each
// thread keeps a 4-column × 8-basis-vector register tile of projections
// (a small SGEMM micro-tile) plus c for its 4 columns.  Squares are summed
// over the thread's 8 basis vectors in registers and across the KT/8
// threads of a column through shared memory.  kb > KT loops over basis
// tiles and re-reads the X panel once per tile.  Ragged d, n and kb are
// handled by masked loads (zero fill) and a masked store: no padding, and
// kb = 0 (an empty basis) still computes c.
//
// Grid: (lanes, ceil(n / BN)) with the lane index MINOR, so the CTAs of
// all lanes of one column panel run close together and share that X panel
// through the 50 MB L2 instead of each lane pulling it from HBM.
#pragma once

#include "stream.cuh"

namespace repro_torch {

constexpr int TD = 16;  // rows of d staged per step

template <typename T, int BN, int KT, bool HAS_R, bool GAIN>
__global__ void __launch_bounds__((BN / 4) * (KT / 8))
proj_gain_kernel(const T* __restrict__ X, int d, int n,
                 const float* __restrict__ B, int kb, long long b_stride,
                 const float* __restrict__ R, long long r_stride,
                 const float* __restrict__ col_sq,
                 const float* __restrict__ base, int lanes_per_base,
                 float* __restrict__ out, float span_tol) {
  constexpr int TX = BN / 4;
  constexpr int TY = KT / 8;
  constexpr int NT = TX * TY;
  __shared__ __align__(16) float Xs[TD][BN];
  __shared__ __align__(16) float Bs[TD][KT];
  __shared__ float Rs[TD];
  __shared__ float red[TY][BN];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int lane = blockIdx.x;
  const int col0 = blockIdx.y * BN;
  const float* Bl = B + lane * b_stride;
  const float* Rl = HAS_R ? R + lane * r_stride : nullptr;

  float s_part[4] = {0.f, 0.f, 0.f, 0.f};
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  const int ktiles = kb > 0 ? (kb + KT - 1) / KT : 1;
  for (int kt = 0; kt < ktiles; ++kt) {
    const int k0 = kt * KT;
    const bool do_c = HAS_R && kt == 0;
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    for (int d0 = 0; d0 < d; d0 += TD) {
      for (int e = tid; e < TD * BN; e += NT) {
        const int r = e / BN, cc = e % BN;
        const int gr = d0 + r, gc = col0 + cc;
        Xs[r][cc] = (gr < d && gc < n)
                        ? to_f32(X[(long long)gr * n + gc]) : 0.f;
      }
      for (int e = tid; e < TD * KT; e += NT) {
        const int r = e / KT, j = e % KT;
        const int gr = d0 + r, gj = k0 + j;
        Bs[r][j] = (gr < d && gj < kb) ? Bl[(long long)gr * kb + gj] : 0.f;
      }
      if (do_c && tid < TD) Rs[tid] = (d0 + tid < d) ? Rl[d0 + tid] : 0.f;
      __syncthreads();
#pragma unroll
      for (int r = 0; r < TD; ++r) {
        const float4 xv = *reinterpret_cast<const float4*>(&Xs[r][tx * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&Bs[r][ty * 8]);
        const float4 b1 = *reinterpret_cast<const float4*>(&Bs[r][ty * 8 + 4]);
        const float x4[4] = {xv.x, xv.y, xv.z, xv.w};
        const float b8[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
        if (do_c) {
          const float rv = Rs[r];
#pragma unroll
          for (int i = 0; i < 4; ++i) c[i] = fmaf(x4[i], rv, c[i]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(x4[i], b8[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s_part[i] = fmaf(acc[i][j], acc[i][j], s_part[i]);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) red[ty][tx * 4 + i] = s_part[i];
  __syncthreads();
  if (ty != 0) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int col = col0 + tx * 4 + i;
    if (col >= n) continue;
    float s = 0.f;
    for (int t = 0; t < TY; ++t) s += red[t][tx * 4 + i];
    float* o = out + (long long)lane * n + col;
    if (!GAIN) {
      *o = s;
      continue;
    }
    const float csq = col_sq[col];
    const float bterm =
        base ? base[(long long)(lane / lanes_per_base) * n + col] : 0.f;
    const float denom = (csq - bterm) - s;
    const float floor_ = span_tol * fmaxf(csq, 1.f);
    const float gain = (c[i] * c[i]) / fmaxf(denom, 1e-30f);
    *o = denom > floor_ ? gain : 0.f;
  }
}

template <typename T, int BN, int KT, bool HAS_R, bool GAIN>
void launch_proj_gain(const void* X, int d, int n, int lanes, const void* B,
                      int kb, long long b_stride, const void* R,
                      long long r_stride, const void* col_sq,
                      const void* base, int lanes_per_base, void* out,
                      float span_tol, cudaStream_t stream) {
  const dim3 grid(lanes, (n + BN - 1) / BN);
  const dim3 block((BN / 4) * (KT / 8));
  proj_gain_kernel<T, BN, KT, HAS_R, GAIN><<<grid, block, 0, stream>>>(
      static_cast<const T*>(X), d, n, static_cast<const float*>(B), kb,
      b_stride, static_cast<const float*>(R), r_stride,
      static_cast<const float*>(col_sq), static_cast<const float*>(base),
      lanes_per_base, static_cast<float*>(out), span_tol);
}

}  // namespace repro_torch
