// aopt_filter_gains — the sample-batched filter engine with its
// A-optimality (Woodbury) epilogue, hand-written for sm_90a.
//
// Replaces the TPU kernels src/repro/kernels/filter_gains/kernel_aopt.py
// (aopt_filter_gains_pallas, epilogue _aopt_epilogue) and, for this
// epilogue, the engine geometry of src/repro/kernels/filter_gains/core.py
// (launch_filter_engine).  For guess g < G and sample i < m of the DASH
// (OPT, α) lattice, s = g·m + i, the perturbed precision of S_g ∪ R_s
// splits as M_s⁻¹ = M_g⁻¹ − E_s E_sᵀ with E_s (d, b) and F_s = E_sᵀE_s, so
// against the guess's shared solve W_g = M_g⁻¹X (G, d, n):
//
//     wsq = ‖w_ga‖²,  xw = x_aᵀ w_ga                    (per guess)
//     t = E_sᵀ x_a,  u = E_sᵀ w_ga                      (b each)
//     num = wsq − 2 uᵀt + tᵀ F_s t                       (clamped at 0)
//     den = 1 + σ⁻² (xw − ‖t‖²)
//     gain[s, a] = σ⁻² max(num, 0) / max(den, 1e-30)
//
// One launch, grid (G · ceil(m / ms), n/128) with the lane index minor:
// one CTA of 8 warps takes one 128-column panel of X and of W_g and
// ms = min(m, 8 / nb) samples of guess g, nb = ceil(b / 8).
//   * All 8 warps stage the X and W_g tiles (16 rows, upcast to f32) and
//     the matching rows of the ms factors E_s in shared memory; each thread
//     holds the next tile's stored values in registers while the current
//     tile is used, and sums wsq and xw of its column over its rows as it
//     stages them — so wsq and xw are those of the stored (possibly bf16)
//     values, as the reference's wrapper computes them from the quantized
//     operands.  The TPU engine took them as per-guess "gcand" inputs.
//   * ms · nb warps compute, each owning one (sample, group of 8 Woodbury
//     columns), each thread a 4-column × 8-entry register tile of t and u.
//   * After the d loop t goes to shared memory, each thread applies its 8
//     rows of F_s (read through the L1), and the partial numerators and
//     ‖t‖² of a column's groups meet in shared memory.
// E_sᵀX, E_sᵀW_g and F_s t are computed here, in this body, as the TPU
// epilogue computes them.
//
// b ≤ 64 (8 groups of 8) runs in this one pass, with at most 37 KB of
// shared memory per CTA.  Ragged d, n and b are masked loads (zero fill)
// and a masked store; b = 0 gives the singleton Sherman–Morrison gain.
//
// b > 64 takes aopt_filter_rounds_kernel below: one sample per CTA, its
// Woodbury columns in rounds of 64 on the same 8 warps × 8-column register
// tiles, the d loop once per round over the same 128-column panel of X and
// W_g (still in the L2).  uᵀt and ‖t‖² are summed across rounds in
// registers; each round's t goes to a (G·m, b, np) f32 scratch the wrapper
// allocates, and F t runs over the whole t after the last round.  No cap
// on b remains.  It is the simple design, not a fast one: 66.4 ms at
// d = 1024, n = 65536, G = 6, m = 8, b = 128, 39 % of its f32 bound, on an
// NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py's timing phase).
//
// What bounds it on the H100: f32 arithmetic, about 4·d·b flops per
// (sample, candidate) — at d = 1024, n = 65536, G = 6, m = 8, b = 8 some
// 1.03e11 flops, 1.5 ms at the 67 TFLOP/s non-tensor f32 peak, against
// 0.56 ms for the bytes (X once, W_g once per guess).  The design keeps
// each staged x and w value against 8 factor entries in registers and,
// by putting a guess's ms samples in one CTA, reads X and W_g once per
// (guess, sample group) instead of once per sample.  No tensor cores:
// TF32 would break the 2e-4 parity with the f32 reference.
#include "stream.cuh"

using namespace repro_torch;

constexpr int SP_TX = 32;              // threads along the columns
constexpr int SP_BN = 4 * SP_TX;       // 128 columns per CTA
constexpr int SP_BT = 8;               // Woodbury columns per thread
constexpr int SP_BCAP = 64;            // largest b of one pass
constexpr int SP_WARPS = 8;            // warps per CTA
constexpr int SP_TD = 16;              // rows of d staged per step

template <typename T>
__global__ void __launch_bounds__(SP_TX * SP_WARPS)
aopt_filter_kernel(const T* __restrict__ X, const T* __restrict__ W, int d,
                   int n, int m, int ms, int nb,
                   const float* __restrict__ E, const float* __restrict__ F,
                   int b, float isig2, float* __restrict__ out) {
  constexpr int NT = SP_TX * SP_WARPS;             // 256 threads
  constexpr int RS = NT / SP_BN;                   // staging row stride
  constexpr int XQ = SP_TD * SP_BN / NT;           // X (and W) values each
  constexpr int EQ = SP_TD * SP_BCAP / NT;         // E values each, at most
  extern __shared__ __align__(16) float smem[];
  const int bw = nb * SP_BT;                   // staged width of E_s, ≥ b
  const int tile = 2 * SP_TD * SP_BN;
  const int tsz = ms * bw * SP_BN;
  const int esz = ms * SP_TD * bw;
  float* Xs = smem;                            // (TD, BN)
  float* Ws = smem + SP_TD * SP_BN;            // (TD, BN)
  float* ts = smem;                            // (ms, bw, BN) after the loop
  float* red = smem;                           // (2, ms·nb, BN) after F t
  float* Es = smem + (tile > tsz ? tile : tsz);  // (ms, TD, bw)
  float* cps = Es + esz;                       // (2, BN): wsq, xw

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;                  // warp: sample sl, group jg
  const int rows = ms * nb;                    // warps that compute
  const bool active = ty < rows;
  const int sl = ty / nb;
  const int jg = ty % nb;
  const int tid = ty * SP_TX + tx;
  const int groups = (m + ms - 1) / ms;
  const int g = blockIdx.x / groups;
  const int i0 = (blockIdx.x % groups) * ms;   // first sample of the CTA
  const int col0 = blockIdx.y * SP_BN;
  const T* Wg = W + (long long)g * d * n;
  const float* Eg = E + (long long)(g * m + i0) * d * b;

  // This thread stages column lc of the panel at rows lr + RS·q, and the
  // E entries tid + NT·q of the (ms, TD, bw) block.
  const int lc = tid % SP_BN, lr = tid / SP_BN;
  const bool lcol = col0 + lc < n;
  T xr[XQ], wr[XQ];
  float er[EQ];
  auto fetch = [&](int d0) {
#pragma unroll
    for (int q = 0; q < XQ; ++q) {
      const int gr = d0 + lr + RS * q;
      const bool in = lcol && gr < d;
      const long long o = (long long)gr * n + col0 + lc;
      xr[q] = in ? X[o] : stream_zero<T>();
      wr[q] = in ? Wg[o] : stream_zero<T>();
    }
#pragma unroll
    for (int q = 0; q < EQ; ++q) {
      const int e = tid + NT * q;
      const int j = e % bw, r = (e / bw) % SP_TD, smp = e / (bw * SP_TD);
      const int gr = d0 + r;
      er[q] = (e < esz && i0 + smp < m && gr < d && j < b)
                  ? Eg[(long long)smp * d * b + (long long)gr * b + j] : 0.f;
    }
  };

  float ta[4][SP_BT], ua[4][SP_BT];
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int j = 0; j < SP_BT; ++j) ta[c][j] = ua[c][j] = 0.f;
  float sw = 0.f, sx = 0.f;                    // column lc, rows lr + RS·q

  fetch(0);
  for (int d0 = 0; d0 < d; d0 += SP_TD) {
#pragma unroll
    for (int q = 0; q < XQ; ++q) {
      const float x = to_f32(xr[q]), w = to_f32(wr[q]);
      Xs[(lr + RS * q) * SP_BN + lc] = x;
      Ws[(lr + RS * q) * SP_BN + lc] = w;
      sw = fmaf(w, w, sw);
      sx = fmaf(x, w, sx);
    }
#pragma unroll
    for (int q = 0; q < EQ; ++q)
      if (tid + NT * q < esz) Es[tid + NT * q] = er[q];
    __syncthreads();
    // The next tile's loads are in flight while this one is used.
    if (d0 + SP_TD < d) fetch(d0 + SP_TD);
    if (active) {
      const float* Er = Es + sl * SP_TD * bw + jg * SP_BT;
#pragma unroll 4
      for (int r = 0; r < SP_TD; ++r) {
        const float4 xv =
            *reinterpret_cast<const float4*>(&Xs[r * SP_BN + tx * 4]);
        const float4 wv =
            *reinterpret_cast<const float4*>(&Ws[r * SP_BN + tx * 4]);
        const float4 e0 = *reinterpret_cast<const float4*>(&Er[r * bw]);
        const float4 e1 = *reinterpret_cast<const float4*>(&Er[r * bw + 4]);
        const float x4[4] = {xv.x, xv.y, xv.z, xv.w};
        const float w4[4] = {wv.x, wv.y, wv.z, wv.w};
        const float e8[SP_BT] = {e0.x, e0.y, e0.z, e0.w,
                                 e1.x, e1.y, e1.z, e1.w};
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int j = 0; j < SP_BT; ++j) {
            ta[c][j] = fmaf(x4[c], e8[j], ta[c][j]);
            ua[c][j] = fmaf(w4[c], e8[j], ua[c][j]);
          }
      }
    }
    __syncthreads();
  }

  // wsq and xw of each column: its RS staging threads meet in cps, in a
  // fixed order (read at the end, after the barriers below).
  for (int h = 0; h < RS; ++h) {
    if (lr == h) {
      cps[lc] = (h == 0 ? 0.f : cps[lc]) + sw;
      cps[SP_BN + lc] = (h == 0 ? 0.f : cps[SP_BN + lc]) + sx;
    }
    __syncthreads();
  }

  // t of every (sample, Woodbury column) to shared memory for F t.
  float* tsl = ts + sl * bw * SP_BN;
  if (active) {
#pragma unroll
    for (int j = 0; j < SP_BT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        tsl[(jg * SP_BT + j) * SP_BN + tx * 4 + c] = ta[c][j];
  }
  __syncthreads();

  const bool live = active && i0 + sl < m;
  const float* Fs = F + (long long)(g * m + i0 + sl) * b * b;
  float pnum[4] = {0.f, 0.f, 0.f, 0.f};
  float ptt[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < SP_BT; ++j) {
    const int k = jg * SP_BT + j;
    if (!live || k >= b) continue;             // warp-uniform
    float ft[4] = {0.f, 0.f, 0.f, 0.f};
    for (int l = 0; l < b; ++l) {
      const float f = __ldg(&Fs[k * b + l]);
      const float4 tv =
          *reinterpret_cast<const float4*>(&tsl[l * SP_BN + tx * 4]);
      ft[0] = fmaf(f, tv.x, ft[0]);
      ft[1] = fmaf(f, tv.y, ft[1]);
      ft[2] = fmaf(f, tv.z, ft[2]);
      ft[3] = fmaf(f, tv.w, ft[3]);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      pnum[c] = fmaf(ta[c][j], ft[c], pnum[c]);
      pnum[c] = fmaf(-2.f * ua[c][j], ta[c][j], pnum[c]);
      ptt[c] = fmaf(ta[c][j], ta[c][j], ptt[c]);
    }
  }
  __syncthreads();                             // every F t has read ts

  if (active) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      red[ty * SP_BN + tx * 4 + c] = pnum[c];
      red[(rows + ty) * SP_BN + tx * 4 + c] = ptt[c];
    }
  }
  __syncthreads();
  if (jg != 0 || !live) return;
  const int s = g * m + i0 + sl;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int lcc = tx * 4 + c;
    const int col = col0 + lcc;
    if (col >= n) continue;
    float num = 0.f, tt = 0.f;
    for (int q = 0; q < nb; ++q) {
      num += red[(sl * nb + q) * SP_BN + lcc];
      tt += red[(rows + sl * nb + q) * SP_BN + lcc];
    }
    num += cps[lcc];
    const float den = 1.f + isig2 * (cps[SP_BN + lcc] - tt);
    out[(long long)s * n + col] = isig2 * fmaxf(num, 0.f) / fmaxf(den, 1e-30f);
  }
}

// b > 64: one sample s per CTA, Woodbury columns in rounds of SP_BCAP.
// Warp jg owns columns c0 + 8·jg … c0 + 8·jg + 7 of round c0 and a 4-column
// × 8-entry register tile of t and u; the staging is the one-pass kernel's.
// ts: this call's (G·m, b, np) scratch of t, written per round and read
// back by the same CTA after a barrier (so through the L1, not the
// read-only path).
template <typename T>
__global__ void __launch_bounds__(SP_TX * SP_WARPS)
aopt_filter_rounds_kernel(const T* __restrict__ X, const T* __restrict__ W,
                          int d, int n, int np, int m,
                          const float* __restrict__ E,
                          const float* __restrict__ F, int b, float isig2,
                          float* __restrict__ ts, float* __restrict__ out) {
  constexpr int NT = SP_TX * SP_WARPS;             // 256 threads
  constexpr int RS = NT / SP_BN;                   // staging row stride
  constexpr int XQ = SP_TD * SP_BN / NT;           // X (and W) values each
  constexpr int EQ = SP_TD * SP_BCAP / NT;         // E values each
  __shared__ __align__(16) float Xs[SP_TD * SP_BN];
  __shared__ __align__(16) float Ws[SP_TD * SP_BN];
  __shared__ __align__(16) float Es[SP_TD * SP_BCAP];
  __shared__ float cps[2 * SP_BN];                 // wsq, xw
  __shared__ float red[2 * SP_WARPS * SP_BN];      // num, ‖t‖² per warp

  const int tx = threadIdx.x;
  const int jg = threadIdx.y;
  const int tid = jg * SP_TX + tx;
  const int s = blockIdx.x;
  const int g = s / m;
  const int col0 = blockIdx.y * SP_BN;
  const T* Wg = W + (long long)g * d * n;
  const float* Es_g = E + (long long)s * d * b;
  const float* Fs = F + (long long)s * b * b;
  float* tsl = ts + (long long)s * b * np + col0 + tx * 4;

  const int lc = tid % SP_BN, lr = tid / SP_BN;
  const bool lcol = col0 + lc < n;
  T xr[XQ], wr[XQ];
  float er[EQ];
  auto fetch = [&](int d0, int c0) {
#pragma unroll
    for (int q = 0; q < XQ; ++q) {
      const int gr = d0 + lr + RS * q;
      const bool in = lcol && gr < d;
      const long long o = (long long)gr * n + col0 + lc;
      xr[q] = in ? X[o] : stream_zero<T>();
      wr[q] = in ? Wg[o] : stream_zero<T>();
    }
#pragma unroll
    for (int q = 0; q < EQ; ++q) {
      const int e = tid + NT * q;
      const int j = e % SP_BCAP, gr = d0 + e / SP_BCAP;
      er[q] = (gr < d && c0 + j < b)
                  ? Es_g[(long long)gr * b + c0 + j] : 0.f;
    }
  };

  float sw = 0.f, sx = 0.f;                    // column lc, rows lr + RS·q
  float pnum[4] = {0.f, 0.f, 0.f, 0.f};        // −2 uᵀt, then + tᵀ F t
  float ptt[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c0 = 0; c0 < b; c0 += SP_BCAP) {
    float ta[4][SP_BT], ua[4][SP_BT];
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int j = 0; j < SP_BT; ++j) ta[c][j] = ua[c][j] = 0.f;
    fetch(0, c0);
    for (int d0 = 0; d0 < d; d0 += SP_TD) {
#pragma unroll
      for (int q = 0; q < XQ; ++q) {
        const float x = to_f32(xr[q]), w = to_f32(wr[q]);
        Xs[(lr + RS * q) * SP_BN + lc] = x;
        Ws[(lr + RS * q) * SP_BN + lc] = w;
        if (c0 == 0) {
          sw = fmaf(w, w, sw);
          sx = fmaf(x, w, sx);
        }
      }
#pragma unroll
      for (int q = 0; q < EQ; ++q) Es[tid + NT * q] = er[q];
      __syncthreads();
      if (d0 + SP_TD < d) fetch(d0 + SP_TD, c0);
      const float* Er = Es + jg * SP_BT;
#pragma unroll 4
      for (int r = 0; r < SP_TD; ++r) {
        const float4 xv =
            *reinterpret_cast<const float4*>(&Xs[r * SP_BN + tx * 4]);
        const float4 wv =
            *reinterpret_cast<const float4*>(&Ws[r * SP_BN + tx * 4]);
        const float4 e0 =
            *reinterpret_cast<const float4*>(&Er[r * SP_BCAP]);
        const float4 e1 =
            *reinterpret_cast<const float4*>(&Er[r * SP_BCAP + 4]);
        const float x4[4] = {xv.x, xv.y, xv.z, xv.w};
        const float w4[4] = {wv.x, wv.y, wv.z, wv.w};
        const float e8[SP_BT] = {e0.x, e0.y, e0.z, e0.w,
                                 e1.x, e1.y, e1.z, e1.w};
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int j = 0; j < SP_BT; ++j) {
            ta[c][j] = fmaf(x4[c], e8[j], ta[c][j]);
            ua[c][j] = fmaf(w4[c], e8[j], ua[c][j]);
          }
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < SP_BT; ++j) {
      const int kk = c0 + jg * SP_BT + j;
      if (kk >= b) continue;                   // warp-uniform
      *reinterpret_cast<float4*>(tsl + (long long)kk * np) =
          make_float4(ta[0][j], ta[1][j], ta[2][j], ta[3][j]);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        pnum[c] = fmaf(-2.f * ua[c][j], ta[c][j], pnum[c]);
        ptt[c] = fmaf(ta[c][j], ta[c][j], ptt[c]);
      }
    }
  }

  // wsq and xw of each column: its RS staging threads meet in cps, in a
  // fixed order.  The barriers also publish every round's t to the CTA.
  for (int h = 0; h < RS; ++h) {
    if (lr == h) {
      cps[lc] = (h == 0 ? 0.f : cps[lc]) + sw;
      cps[SP_BN + lc] = (h == 0 ? 0.f : cps[SP_BN + lc]) + sx;
    }
    __syncthreads();
  }

  // tᵀ F t: warp jg takes rows jg, jg + 8, … of F_s.
  for (int kk = jg; kk < b; kk += SP_WARPS) {
    float ft[4] = {0.f, 0.f, 0.f, 0.f};
    for (int l = 0; l < b; ++l) {
      const float f = __ldg(&Fs[(long long)kk * b + l]);
      const float4 tv = *reinterpret_cast<const float4*>(
          tsl + (long long)l * np);
      ft[0] = fmaf(f, tv.x, ft[0]);
      ft[1] = fmaf(f, tv.y, ft[1]);
      ft[2] = fmaf(f, tv.z, ft[2]);
      ft[3] = fmaf(f, tv.w, ft[3]);
    }
    const float4 tk =
        *reinterpret_cast<const float4*>(tsl + (long long)kk * np);
    pnum[0] = fmaf(tk.x, ft[0], pnum[0]);
    pnum[1] = fmaf(tk.y, ft[1], pnum[1]);
    pnum[2] = fmaf(tk.z, ft[2], pnum[2]);
    pnum[3] = fmaf(tk.w, ft[3], pnum[3]);
  }

#pragma unroll
  for (int c = 0; c < 4; ++c) {
    red[jg * SP_BN + tx * 4 + c] = pnum[c];
    red[(SP_WARPS + jg) * SP_BN + tx * 4 + c] = ptt[c];
  }
  __syncthreads();
  if (jg != 0) return;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int lcc = tx * 4 + c;
    const int col = col0 + lcc;
    if (col >= n) continue;
    float num = 0.f, tt = 0.f;
    for (int q = 0; q < SP_WARPS; ++q) {
      num += red[q * SP_BN + lcc];
      tt += red[(SP_WARPS + q) * SP_BN + lcc];
    }
    num += cps[lcc];
    const float den = 1.f + isig2 * (cps[SP_BN + lcc] - tt);
    out[(long long)s * n + col] = isig2 * fmaxf(num, 0.f) / fmaxf(den, 1e-30f);
  }
}

template <typename T>
static void launch_aopt_filter(const void* X, const void* W, int d, int n,
                               int G, int m, const void* E, const void* F,
                               int b, float isig2, void* scratch, void* out,
                               cudaStream_t s) {
  const dim3 block(SP_TX, SP_WARPS);
  if (b > SP_BCAP) {
    const int np = SP_BN * ((n + SP_BN - 1) / SP_BN);
    const dim3 grid(G * m, np / SP_BN);
    aopt_filter_rounds_kernel<T><<<grid, block, 0, s>>>(
        static_cast<const T*>(X), static_cast<const T*>(W), d, n, np, m,
        static_cast<const float*>(E), static_cast<const float*>(F), b, isig2,
        static_cast<float*>(scratch), static_cast<float*>(out));
    return;
  }
  const int nb = b > 0 ? (b + SP_BT - 1) / SP_BT : 1;
  const int ms = m < SP_WARPS / nb ? m : SP_WARPS / nb;
  const int groups = (m + ms - 1) / ms;
  const int bw = nb * SP_BT;
  const int tile = 2 * SP_TD * SP_BN, tsz = ms * bw * SP_BN;
  const size_t smem = sizeof(float) *
      ((tile > tsz ? tile : tsz) + ms * SP_TD * bw + 2 * SP_BN);
  const dim3 grid(G * groups, (n + SP_BN - 1) / SP_BN);
  aopt_filter_kernel<T><<<grid, block, smem, s>>>(
      static_cast<const T*>(X), static_cast<const T*>(W), d, n, m, ms, nb,
      static_cast<const float*>(E), static_cast<const float*>(F), b, isig2,
      static_cast<float*>(out));
}

// X: (d, n), W: (G, d, n), both f32 or both bf16 (bf16 != 0); E: (G, m,
// d, b), F: (G, m, b, b) f32 with b ≥ 0; out: (G, m, n) f32.  For b > 64,
// scratch holds scratch_elems ≥ G · m · b · np f32 (np = 128·⌈n/128⌉);
// otherwise it is not read.  All contiguous, on the card.
extern "C" int aopt_filter_gains_launch(const void* X, const void* W,
                                        int bf16, int d, int n, int G, int m,
                                        const void* E, const void* F, int b,
                                        float isig2, void* scratch,
                                        long long scratch_elems, void* out,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long np = SP_BN * ((n + SP_BN - 1LL) / SP_BN);
  if (b < 0 || (b > SP_BCAP && scratch_elems < (long long)G * m * b * np))
    return static_cast<int>(cudaErrorInvalidValue);
  if (bf16) {
    launch_aopt_filter<__nv_bfloat16>(X, W, d, n, G, m, E, F, b, isig2,
                                      scratch, out, s);
  } else {
    launch_aopt_filter<float>(X, W, d, n, G, m, E, F, b, isig2, scratch, out,
                              s);
  }
  return static_cast<int>(cudaGetLastError());
}
