// aopt_gains — the A-optimality Sherman–Morrison singleton sweep,
// hand-written for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/aopt_gains/kernel.py
// (aopt_gains_pallas, body _aopt_kernel).  Per lane g and candidate
// column a of X (d, n), with the lane's cached shared solve
// W_g = M_g⁻¹X (G, d, n):
//
//     gain[g, a] = σ⁻² ‖w_ga‖² / max(1 + σ⁻² x_aᵀ w_ga, 1e-30)
//
// The lane axis G carries the DASH guess lattice (one launch serves every
// guess's current-state fallback); greedy and top-k call it with G = 1.
// bf16 storage is upcast right after the load; the sums are f32.
//
// What bounds it on the H100: bytes.  A lane reads 2·d·n stored values
// for 4·d·n flops — 1 flop per byte in f32, far below the card's ~20
// flop/byte f32 balance point.  The design is a coalesced stream: a CTA
// is 32 columns × 8 row groups (one warp per row group); the 32 threads
// of a warp read 32 adjacent columns of one row (128 B in f32), each
// thread walks its column's rows in steps of 8 with four rows in flight,
// and the 8 partial sums of a column meet in shared memory.  No padding:
// a column past n reads nothing and writes nothing.
//
// Grid: (lanes, ceil(n / 32)) with the lane index MINOR, so the lanes of
// one column panel run together and read that X panel through the L2;
// past 65,535 panels the launch is split into panel ranges.
#include "stream.cuh"

using namespace repro_torch;

constexpr int AG_BN = 32;  // columns per CTA: one per thread of a warp
constexpr int AG_RG = 8;   // row groups per CTA: one warp each

template <typename T>
__global__ void __launch_bounds__(AG_BN * AG_RG)
aopt_gains_kernel(const T* __restrict__ X, const T* __restrict__ W, int d,
                  int n, int panel0, float isig2, float* __restrict__ out) {
  __shared__ float red[2][AG_RG][AG_BN];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int g = blockIdx.x;
  const int col = (panel0 + blockIdx.y) * AG_BN + tx;
  const T* Wg = W + (long long)g * d * n;

  float sw = 0.f, sx = 0.f;
  if (col < n) {
    int r = ty;
    for (; r + 3 * AG_RG < d; r += 4 * AG_RG) {
      float x[4], w[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const long long o = (long long)(r + u * AG_RG) * n + col;
        x[u] = to_f32(X[o]);
        w[u] = to_f32(Wg[o]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        sw = fmaf(w[u], w[u], sw);
        sx = fmaf(x[u], w[u], sx);
      }
    }
    for (; r < d; r += AG_RG) {
      const long long o = (long long)r * n + col;
      const float x = to_f32(X[o]);
      const float w = to_f32(Wg[o]);
      sw = fmaf(w, w, sw);
      sx = fmaf(x, w, sx);
    }
  }
  red[0][ty][tx] = sw;
  red[1][ty][tx] = sx;
  __syncthreads();
  if (ty != 0 || col >= n) return;
  float wsq = 0.f, xw = 0.f;
#pragma unroll
  for (int t = 0; t < AG_RG; ++t) {
    wsq += red[0][t][tx];
    xw += red[1][t][tx];
  }
  out[(long long)g * n + col] =
      isig2 * wsq / fmaxf(1.f + isig2 * xw, 1e-30f);
}

// gridDim.y's limit: one launch takes at most this many column panels.
constexpr int AG_MAX_PANELS = 65535;

// Launches of at most AG_MAX_PANELS panels each, so any n runs.
template <typename T>
static cudaError_t launch_aopt_gains(const void* X, const void* W, int d,
                                     int n, int G, float isig2, void* out,
                                     cudaStream_t s) {
  const int total = (n + AG_BN - 1) / AG_BN;
  const dim3 block(AG_BN, AG_RG);
  for (int p0 = 0; p0 < total; p0 += AG_MAX_PANELS) {
    const int panels = total - p0 < AG_MAX_PANELS ? total - p0
                                                  : AG_MAX_PANELS;
    aopt_gains_kernel<T><<<dim3(G, panels), block, 0, s>>>(
        static_cast<const T*>(X), static_cast<const T*>(W), d, n, p0, isig2,
        static_cast<float*>(out));
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// X: (d, n), W: (G, d, n), both f32 or both bf16 (bf16 != 0); out: (G, n)
// f32.  All contiguous, on the card.
extern "C" int aopt_gains_launch(const void* X, const void* W, int bf16,
                                 int d, int n, int G, float isig2, void* out,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      bf16 ? launch_aopt_gains<__nv_bfloat16>(X, W, d, n, G, isig2, out, s)
           : launch_aopt_gains<float>(X, W, d, n, G, isig2, out, s));
}
