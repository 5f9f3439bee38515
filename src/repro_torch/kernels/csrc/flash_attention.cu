// flash_attention — online-softmax attention with GQA, causal and
// sliding-window masks, logit softcap, q_offset and ragged Sq/Skv,
// hand-written for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention_pallas, body _flash_kernel).  It computes the same
// function: s = (q·k)·D^-½ in f32, optionally c·tanh(s/c), masked to
// −1e30 where kpos ≥ Skv, where causal and qpos + q_offset < kpos, or
// where a window is set and qpos + q_offset − kpos ≥ window; the online
// softmax (m, l, acc) in f32; P cast to v's type before P·V; out =
// acc / max(l, 1e-30) in q's type.  q, k, v, o keep the model's
// (B, S, H, D) layout: the kernel reads rows with the head stride, so the
// wrapper neither pads nor transposes.  GQA maps query head h to KV head
// h / (H / Hkv).
//
// No sequential grid on Hopper: on the TPU the last grid axis walked the
// KV blocks of one output block in order, carrying (m, l, acc) in VMEM
// scratch.  Here a CTA owns a tile of query rows and loops over the KV
// blocks itself, the state in registers.  KV blocks that lie wholly
// outside the causal or window band of the CTA's rows are skipped: in the
// TPU kernel they add exp(−1e30 − m) = 0 after the correction, so the
// function is the same, and an 8192-token prefill with window 4096 does
// S·W work instead of S².  Inside a visited block a masked entry adds
// p = 0 (the TPU kernel adds exp(−1e30 − m), which is 0 once a row has
// seen a valid key and is wiped by the next correction before that), so a
// row that has no valid key at all comes out 0; such rows have no
// agreed value (the plain version averages V, the TPU kernel averages V
// and its zero padding) and no caller makes them.  −1e30 stays finite so
// that no exp(−inf + inf) makes a NaN.
//
// Three kernels, chosen by dtype and head_dim:
//   * bf16, D ∈ {64, 80, 128, 256} — the serving path: flash_wgmma_kernel.
//     - One K/V tile per GQA group.  A CTA owns (b, KV head, a run of
//       positions) and stacks the n_rep query heads of the group into the
//       rows of its 192-row tile: row r is (position q0 + r / n_rep, head
//       r % n_rep), so every row shares the K/V band and each K/V tile is
//       staged once for all the heads that read it (48 positions × 4 heads
//       for danube).
//     - An asynchronous K/V ring, warp-specialised: a producer warpgroup
//       (40 registers after setmaxnreg) keeps a 3-stage ring of 128-key
//       K and V blocks filled with cp.async (zero-fill past Skv; each
//       thread's source offsets computed once), its copies arriving on
//       the stage's "full" mbarrier as they land; the consumers release a
//       stage on its "empty" mbarrier.  No CTA-wide barrier in the loop.
//       16-byte chunks land in wgmma's core-matrix order (8 rows × 16
//       bytes, no swizzle), which fits any head_dim that is a multiple of
//       8, 80 included.
//     - wgmma: three consumer warpgroups of 64 rows at 152 registers; S =
//       QKᵀ is m64n128k16 with Q and K read from shared memory through
//       descriptors, O += P·V is m64nDk16 with P as register A operand and
//       V read MN-major (imm-trans-b) straight from the ring, so nothing
//       is transposed.
//     - D 256 (recurrentgemma's local attention): the same kernel with two
//       consumer warpgroups at 232 registers (the 64 × 256 f32 output
//       tile alone takes 128 a thread), 64-key blocks in a 2-stage ring
//       (192 KB of shared memory with the 128-row Q tile), S = QKᵀ as
//       m64n64k16 and O += P·V as two m64n128k16 halves.
//     - Only KV blocks on the edge of the band (the diagonal, the window
//       edge, the ragged end) test each (q, k) pair; blocks wholly inside
//       it skip the mask.  exp2 is one FFMA and one MUFU.EX2 per score.
//   * bf16, D ∈ {16, 32}: mma.sync.m16n8k16 in FA2's register layout, one
//     CTA per (b, query head, 64 rows), K and Vᵀ staged synchronously.
//   * f32: CUDA cores (the tensor cores' f32 input is TF32, about three
//     decimal digits, which cannot meet the reference's 2e-5): a 64 × 64
//     score tile per CTA, each of 128 threads 4 rows × 8 keys, P through
//     shared memory (at D 256, 213,760 bytes of it, one CTA an SM; each
//     thread holds 4 rows × 32 output columns).
//
// What bounds it on the H100: the tensor cores, with the special-function
// units close behind.  The valid (q, k) pairs of one (b, h) cost 4·D
// flops each (QKᵀ and P·V) and one exp2 each: at the serving shape (B 4,
// S 8192, H 32, Hkv 8, D 80, window 4096, causal) 1.03 TFLOP per layer,
// 1.04 ms at 989 TFLOP/s, against 0.77 ms for 3.2e9 exp2 on the SFUs and
// 0.125 ms for reading Q, K, V and writing O once at 3.35 TB/s.  Each
// consumer warpgroup still runs its softmax between its own two products:
// the three warpgroups overlap one another's softmax and wgmma, but
// overlapping a warpgroup's softmax with its own previous P·V needs more
// registers than 152 and was slower, and so was ordering the
// warpgroups' products in turn (ping-pong).  The f32
// kernel is bound by the CUDA cores' 67 TFLOP/s.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int BQ = 64;        // query rows per CTA (mma.sync and f32)
constexpr int BK = 64;        // keys per KV block
constexpr int THREADS = 128;  // 4 warps

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int Sq, Skv, H, n_rep;
  int causal, window, q_offset;
  float scale;    // D^-1/2
  float softcap;  // 0 = off
  int group;      // query heads per CTA (wgmma kernel)
};

__device__ __forceinline__ bool valid_pair(const Params& p, int qpos,
                                           int kpos) {
  const int rel = qpos - kpos;
  bool ok = kpos < p.Skv;
  if (p.causal) ok = ok && rel >= 0;
  if (p.window > 0) ok = ok && rel < p.window;
  return ok;
}

// Score in natural units → log2 units (exp(s − m) = exp2(t − m₂)), or
// NEG_INF where the pair is masked.
__device__ __forceinline__ float score_log2(const Params& p, float dot,
                                            int qpos, int kpos) {
  float x = dot * p.scale;
  if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
  return valid_pair(p, qpos, kpos) ? x * LOG2E : NEG_INF;
}

// The KV blocks [kb0, kb1) of BKV keys that hold a valid key for some
// query position in [qlo, qhi] (q_offset included).
template <int BKV>
__device__ __forceinline__ void kv_band(const Params& p, int qlo, int qhi,
                                        int& kb0, int& kb1) {
  int end = p.Skv;
  if (p.causal) end = min(end, qhi + 1);
  int begin = 0;
  if (p.window > 0) begin = max(0, qlo - p.window + 1);
  kb0 = begin / BKV;
  kb1 = end > begin ? (end + BKV - 1) / BKV : kb0;
}

// ... of the BQ-row query block starting at row q0.
__device__ __forceinline__ void kv_block_range(const Params& p, int q0,
                                               int& kb0, int& kb1) {
  kv_band<BK>(p, q0 + p.q_offset, min(q0 + BQ, p.Sq) - 1 + p.q_offset,
              kb0, kb1);
}

// ---------------------------------------------------------------------------
// bf16, D ∈ {16, 32}: tensor cores (mma.sync m16n8k16)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int D>
struct MmaSmem {
  static constexpr int QP = D + 8;   // Q and K row pitch (16 B of pad)
  static constexpr int VP = BK + 8;  // Vᵀ row pitch
  static constexpr int BYTES = (BQ * QP + BK * QP + D * VP) * 2;
};

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_mma_kernel(Params p) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int QP = MmaSmem<D>::QP;
  constexpr int VP = MmaSmem<D>::VP;
  constexpr int KT = D / 16;  // k-steps of QKᵀ
  constexpr int NT = BK / 8;  // n-tiles of the score tile
  constexpr int DT = D / 8;   // n-tiles of the output
  constexpr int V8 = D / 8;   // 16-byte vectors per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BQ * QP;
  __nv_bfloat16* Vt = Ks + BK * QP;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / p.n_rep;
  const long long q_pitch = (long long)p.H * D;
  const long long kv_pitch = (long long)(p.H / p.n_rep) * D;
  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) +
                            (long long)b * p.Sq * q_pitch + (long long)h * D;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) +
                            (long long)b * p.Skv * kv_pitch +
                            (long long)hk * D;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) +
                            (long long)b * p.Skv * kv_pitch +
                            (long long)hk * D;
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) +
                      (long long)b * p.Sq * q_pitch + (long long)h * D;

  for (int i = tid; i < BQ * V8; i += THREADS) {
    const int r = i / V8, c = (i % V8) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < p.Sq)
      val = *reinterpret_cast<const uint4*>(qg + (q0 + r) * q_pitch + c);
    *reinterpret_cast<uint4*>(Qs + r * QP + c) = val;
  }
  __syncthreads();

  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  uint32_t qf[KT][4];
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    const int c = kt * 16 + 2 * t;
    qf[kt][0] = ld32(Qs + r0 * QP + c);
    qf[kt][1] = ld32(Qs + (r0 + 8) * QP + c);
    qf[kt][2] = ld32(Qs + r0 * QP + c + 8);
    qf[kt][3] = ld32(Qs + (r0 + 8) * QP + c + 8);
  }

  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};
  const int qpos0 = q0 + r0 + p.q_offset;

  int kb0, kb1;
  kv_block_range(p, q0, kb0, kb1);
  for (int kb = kb0; kb < kb1; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();  // the previous block's tiles are no longer read
    for (int i = tid; i < BK * V8; i += THREADS) {
      const int r = i / V8, c = (i % V8) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < p.Skv)
        val = *reinterpret_cast<const uint4*>(kg + (k0 + r) * kv_pitch + c);
      *reinterpret_cast<uint4*>(Ks + r * QP + c) = val;
    }
    // Vᵀ: each thread takes two adjacent keys of one 8-wide column chunk
    // and writes 8 words of (key, key + 1) pairs.
    for (int i = tid; i < (BK / 2) * V8; i += THREADS) {
      const int r = (i / V8) * 2, c = (i % V8) * 8;
      uint4 v0 = make_uint4(0u, 0u, 0u, 0u), v1 = v0;
      if (k0 + r < p.Skv)
        v0 = *reinterpret_cast<const uint4*>(vg + (k0 + r) * kv_pitch + c);
      if (k0 + r + 1 < p.Skv)
        v1 = *reinterpret_cast<const uint4*>(vg + (k0 + r + 1) * kv_pitch +
                                             c);
      const __nv_bfloat16* e0 = reinterpret_cast<const __nv_bfloat16*>(&v0);
      const __nv_bfloat16* e1 = reinterpret_cast<const __nv_bfloat16*>(&v1);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        __nv_bfloat162 pair;
        pair.x = e0[e];
        pair.y = e1[e];
        *reinterpret_cast<__nv_bfloat162*>(Vt + (c + e) * VP + r) = pair;
      }
    }
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const __nv_bfloat16* krow = Ks + (j * 8 + g) * QP + 2 * t;
#pragma unroll
      for (int kt = 0; kt < KT; ++kt)
        mma_bf16(s[j], qf[kt], ld32(krow + kt * 16), ld32(krow + kt * 16 + 8));
    }

    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + j * 8 + 2 * t + (e & 1);
        const float x = score_log2(p, s[j][e], qpos0 + (e >> 1) * 8, kpos);
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[j][e];
        const float pe = x == NEG_INF ? 0.f : exp2f(x - m[e >> 1]);
        s[j][e] = pe;
        rs[e >> 1] += pe;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rs[r];
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      acc[j][0] *= corr[0];
      acc[j][1] *= corr[0];
      acc[j][2] *= corr[1];
      acc[j][3] *= corr[1];
    }

    // P·V: the score tiles 2kk, 2kk + 1 are the A operand of k-step kk.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        const __nv_bfloat16* vrow = Vt + (j * 8 + g) * VP + kk * 16 + 2 * t;
        mma_bf16(acc[j], a, ld32(vrow), ld32(vrow + 8));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + r * 8;
    if (row >= p.Sq) continue;
    const float den = fmaxf(l[r], 1e-30f);
    __nv_bfloat16* orow = og + row * q_pitch + 2 * t;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      __nv_bfloat162 out =
          __floats2bfloat162_rn(acc[j][2 * r] / den, acc[j][2 * r + 1] / den);
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8) = out;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16, D ∈ {64, 80, 128}: wgmma over an asynchronous K/V ring
// ---------------------------------------------------------------------------

constexpr int LOADERS = 128;  // the producer warpgroup's threads
// Registers per thread after setmaxnreg: the producer gives up its share
// to the consumers (128·(PRODUCER_REGS + NWG·CONSUMER_REGS) ≤ 65536).
// 40 rather than 56, which gives the consumers the same 152, measured
// faster on the card.
constexpr int PRODUCER_REGS = 40;

// The CTA's warpgroups: NWG consumers of 64 rows each plus one producer
// that only loads K and V.  Up to D 128 three consumers at 152 registers;
// at D 256 a 64 × 256 f32 accumulator takes 128 registers a thread beside
// the 64-key score tile's 32 and its bf16 copy's 16, so two consumers at
// 232.
template <int D>
struct WgCfg {
  static constexpr int NWG = D <= 128 ? 3 : 2;
  static constexpr int THREADS = 128 * (NWG + 1);
  static constexpr int BM = 64 * NWG;  // (position, head) rows per CTA
  static constexpr int CONSUMER_REGS =
      (65536 / 128 - PRODUCER_REGS) / NWG / 8 * 8;
};

template <int D>
struct WgSmem {
  static constexpr int BK = D <= 80 ? 128 : 64;   // keys per K/V block
  static constexpr int STAGES = D <= 80 ? 3 : 2;  // K/V ring depth
  static constexpr int TILE = BK * D * 2;  // one K or V tile, bytes
  static constexpr int Q = WgCfg<D>::BM * D * 2;
  static constexpr int BARS = 2 * STAGES * 8;  // full and empty mbarriers
  static constexpr int BYTES = Q + STAGES * 2 * TILE + BARS;
};

template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  // D[64 x 64] (+)= A[64 x 16] · B[64 x 16]ᵀ, A and B from shared memory.
  static __device__ __forceinline__ void ss(float (&d)[8][4], uint64_t da,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
        "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
        "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
        "%30, %31},"
        " %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
        : "l"(da), "l"(db), "r"(scale_d));
  }
  // D[64 x 64] += A[64 x 16] · B[16 x 64], A from registers, B from shared
  // memory in MN-major layout (imm-trans-b = 1).
  static __device__ __forceinline__ void rs(float (&d)[8][4],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
        "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
        "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
        "%30, %31},"
        " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<80> {
  // D[64 x 80] += A[64 x 16] · B[16 x 80], A from registers, B from shared
  // memory in MN-major layout (imm-trans-b = 1).
  static __device__ __forceinline__ void rs(float (&d)[10][4],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
        "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
        "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
        "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39},"
        " {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  // D[64 x 128] (+)= A[64 x 16] · B[128 x 16]ᵀ, A and B from shared memory.
  static __device__ __forceinline__ void ss(float (&d)[16][4], uint64_t da,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
        "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
        "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
        "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
        "%60, %61, %62, %63},"
        " %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
        : "l"(da), "l"(db), "r"(scale_d));
  }
  // D[64 x 128] += A[64 x 16] · B[16 x 128], A from registers, B from shared
  // memory in MN-major layout (imm-trans-b = 1).
  static __device__ __forceinline__ void rs(float (&d)[16][4],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
        "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
        "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
        "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
        "%60, %61, %62, %63},"
        " {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<256> {
  // D[64 x 256] += A[64 x 16] · B[16 x 256] as two m64n128k16 products:
  // columns 128–255 of B start 16 core matrices (2048 bytes, 128
  // descriptor units) after columns 0–127 in the MN-major layout.
  static __device__ __forceinline__ void rs(float (&d)[32][4],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
    Wgmma<128>::rs(*reinterpret_cast<float(*)[16][4]>(&d[0]), a, db);
    Wgmma<128>::rs(*reinterpret_cast<float(*)[16][4]>(&d[16]), a, db + 128);
  }
};


__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16 bytes global → shared without passing through registers; the
// destination is zero-filled when !ok (src is then never read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// cp.async writes through the generic proxy, wgmma reads through the
// async proxy: after the copies are known to have landed, the fence
// orders them before this thread's wgmma.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin registers that an asynchronous wgmma reads or writes: the compiler
// may not move their other uses across this point.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(r[j][e])::"memory");
}

template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[j][e])::"memory");
}

// wgmma shared-memory descriptor without swizzle: the operand is a grid
// of core matrices, 8 rows × 16 bytes each in 128 contiguous bytes; lbo
// is the byte step between core matrices along K, sbo along M or N.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// 16-byte chunk i of a tile of D-wide bf16 rows lands at byte 16·i, with
// i = ((row / 8)·(D / 8) + col / 8)·8 + row % 8: core matrix (row group,
// column chunk) at ((row / 8)·(D / 8) + col / 8)·128.  Eight adjacent
// threads fill one core matrix and read 16 bytes of each of 8 rows.
template <int D>
__device__ __forceinline__ int chunk_row(int i) {
  return ((i >> 3) / (D / 8)) * 8 + (i & 7);
}
template <int D>
__device__ __forceinline__ int chunk_col(int i) {
  return ((i >> 3) % (D / 8)) * 8;
}

// One loader's 16-byte chunks of a BK × D K or V tile: chunk c is tile
// chunk lt + c·LOADERS (lt: the thread's rank among the LOADERS), its
// source offset from the tile's first row computed once, not per block
// (the division by D / 8 per chunk cost the loop dearly), −1 past the
// tile.
template <int D>
struct KvChunks {
  static constexpr int BK = WgSmem<D>::BK;
  static constexpr int TOTAL = BK * D / 8;
  static constexpr int N = (TOTAL + LOADERS - 1) / LOADERS;
  int lt;
  int off[N];

  __device__ __forceinline__ KvChunks(long long pitch, int lt_) : lt(lt_) {
#pragma unroll
    for (int c = 0; c < N; ++c) {
      const int i = lt + c * LOADERS;
      off[c] = i < TOTAL ? static_cast<int>(chunk_row<D>(i) * pitch) +
                               chunk_col<D>(i)
                         : -1;
    }
  }

  // The tile whose first row is src into shared memory at dst; rows at
  // or past nvalid (the ragged end of Skv) are zero-filled.
  __device__ __forceinline__ void load(uint32_t dst, const __nv_bfloat16* src,
                                       int nvalid) const {
    const uint32_t d = dst + 16 * lt;
    if (nvalid >= BK) {
#pragma unroll
      for (int c = 0; c < N; ++c)
        if (c + 1 < N || off[c] >= 0)
          cp_async16(d + 16 * LOADERS * c, src + off[c], true);
    } else {
#pragma unroll
      for (int c = 0; c < N; ++c) {
        const int i = lt + c * LOADERS;
        if (i >= TOTAL) continue;
        const bool ok = chunk_row<D>(i) < nvalid;
        cp_async16(d + 16 * LOADERS * c, src + (ok ? off[c] : 0), ok);
      }
    }
  }
};

// mbarriers of the warp-specialised ring: the producer's cp.async
// arrive on full[s] as they land, the consumers on empty[s] once their
// products have read stage s.
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Arrives on bar when all of this thread's earlier cp.async have landed.
__device__ __forceinline__ void mbar_arrive_cp_async(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred P1;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// exp2 on the special-function unit; subnormal results flush to 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The dots of one thread's two rows (qpos[0], qpos[1]) and its keys
// k0 + 8j + 2t + {0, 1}, in place → softmax logits t in units where
// p = exp2((t − m)·c): t = dot with c = D^-½·log2 e, or with a softcap
// t = cap·tanh(dot·D^-½ / cap) and c = log2 e.  Masked pairs (tested only
// when MASK) get NEG_INF.  mx gets each row's largest t.
template <bool MASK, int NT>
__device__ __forceinline__ void score_tile(const Params& p, float (&s)[NT][4],
                                           const int (&qpos)[2], int kpos0,
                                           float (&mx)[2]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[j][e];
      if (p.softcap > 0.f) x = p.softcap * tanhf(x * p.scale / p.softcap);
      if (MASK && !valid_pair(p, qpos[e >> 1], kpos0 + j * 8 + (e & 1)))
        x = NEG_INF;
      s[j][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
}

// Logits → p = exp2(t·c − m·c) in place (one FFMA and one EX2 each), row
// sums into rs.  mc[r] is −m·c, or 0 while row r has seen no valid key:
// then every t is NEG_INF and exp2(NEG_INF·c) = 0, a masked pair's p.
template <int NT>
__device__ __forceinline__ void prob_tile(float (&s)[NT][4], float c,
                                          const float (&mc)[2],
                                          float (&rs)[2]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float pe = ex2(fmaf(s[j][e], c, mc[e >> 1]));
      s[j][e] = pe;
      rs[e >> 1] += pe;
    }
  }
}

// O += P·V as one fenced wgmma stage, issued and committed, not waited
// for (ptxas keeps a stage asynchronous only when no other instruction
// defines its registers after the fence): BK / 16 k-steps of 16
// keys, each 2 core matrices of V (16·D bytes apart) deep.  sV is the V
// tile in core-matrix order, read MN-major: lbo steps K (8 keys), sbo
// steps N (8 columns).
template <int D, int PT>
__device__ __forceinline__ void pv(float (&acc)[D / 8][4],
                                   uint32_t (&pa)[PT][4], uint32_t sV) {
  const uint64_t vdesc = smem_desc(sV, 16 * D, 128);
  pin(acc);
  pin(pa);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < PT; ++kk)
    Wgmma<D>::rs(acc, pa[kk], vdesc + 2 * D * kk);
  wgmma_commit();
}

template <int D>
__global__ void __launch_bounds__(WgCfg<D>::THREADS, 1)
flash_wgmma_kernel(Params p) {
  static_assert(D % 16 == 0 && (D <= 128 || D == 256),
                "head_dim: a multiple of 16, ≤ 128, or 256");
  constexpr int NWG = WgCfg<D>::NWG;
  constexpr int BM = WgCfg<D>::BM;
  constexpr int WG_THREADS = WgCfg<D>::THREADS;
  constexpr int WBK = WgSmem<D>::BK;  // keys per K/V block
  constexpr int KT = D / 16;    // k-steps of QKᵀ
  constexpr int NT = WBK / 8;   // n8 column tiles of the score tile
  constexpr int DT = D / 8;     // n8 column tiles of the output
  constexpr int PT = WBK / 16;  // k-steps of P·V
  constexpr int STAGES = WgSmem<D>::STAGES;
  constexpr int TILE = WgSmem<D>::TILE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t sQ = smem_u32(smem_raw);
  const uint32_t sKV = sQ + WgSmem<D>::Q;  // stage s: K, then V

  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // This CTA: batch b, KV head hk, query heads [h0, h1) (G of them, the
  // whole group unless n_rep > BM) at positions [q0, q1); tile row r is
  // (position q0 + r / G, head h0 + r % G).
  const int G = p.group, P = BM / G;
  const int chunks = (p.n_rep + G - 1) / G;
  const int hk = blockIdx.y / chunks;
  const int h0 = hk * p.n_rep + (blockIdx.y % chunks) * G;
  const int h1 = min(h0 + G, (hk + 1) * p.n_rep);
  const int q0 = blockIdx.x * P, q1 = min(q0 + P, p.Sq);
  const int b = blockIdx.z;
  const long long q_pitch = (long long)p.H * D;
  const long long kv_pitch = (long long)(p.H / p.n_rep) * D;
  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) +
                            (long long)b * p.Sq * q_pitch;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) +
                            (long long)b * p.Skv * kv_pitch +
                            (long long)hk * D;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) +
                            (long long)b * p.Skv * kv_pitch +
                            (long long)hk * D;
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) +
                      (long long)b * p.Sq * q_pitch;

  // Q: the BM rows in core-matrix order, zero rows past the tile.
  for (int i = tid; i < BM * D / 8; i += WG_THREADS) {
    const int r = chunk_row<D>(i);
    const int pos = q0 + r / G, h = h0 + r % G;
    const bool ok = pos < q1 && h < h1;
    cp_async16(sQ + 16 * i,
               qg + (ok ? pos * q_pitch + (long long)h * D : 0) +
                   chunk_col<D>(i),
               ok);
  }
  cp_async_commit();

  const int qlo = q0 + p.q_offset, qhi = q1 - 1 + p.q_offset;
  int kb0, kb1;
  kv_band<WBK>(p, qlo, qhi, kb0, kb1);
  // Block kb lives in stage (kb − kb0) % STAGES: K, then V.  The stage's
  // full mbarrier sits at bars + 8·s, its empty one at bars + 8·(STAGES +
  // s).
  const uint32_t bars = sKV + STAGES * 2 * TILE;
  auto load_block = [&](const KvChunks<D>& kvc, int kb) {
    const long long k0 = (long long)kb * WBK;
    const uint32_t dst = sKV + ((kb - kb0) % STAGES) * 2 * TILE;
    const int nvalid = p.Skv - kb * WBK;
    kvc.load(dst, kg + k0 * kv_pitch, nvalid);
    kvc.load(dst + TILE, vg + k0 * kv_pitch, nvalid);
  };
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 8 * s, LOADERS);
      mbar_init(bars + 8 * (STAGES + s), 128 * NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();  // Q has landed, the mbarriers are set
  if (wg == NWG) {
    // The producer: refills stage s once the consumers have released it,
    // its copies arriving on the stage's full mbarrier as they land.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        PRODUCER_REGS));
    const KvChunks<D> kvc(kv_pitch, tid - 128 * NWG);
    for (int kb = kb0; kb < kb1; ++kb) {
      const int j = kb - kb0, s = j % STAGES;
      if (j >= STAGES)
        mbar_wait(bars + 8 * (STAGES + s), (j / STAGES - 1) & 1);
      load_block(kvc, kb);
      mbar_arrive_cp_async(bars + 8 * s);
    }
    cp_async_wait<0>();
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      WgCfg<D>::CONSUMER_REGS));

  // This thread's two rows: r0 and r0 + 8 of its warpgroup's 64.
  const int r0 = wg * 64 + warp * 16 + g;
  int qpos[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) qpos[r] = q0 + (r0 + 8 * r) / G + p.q_offset;
  const uint64_t qdesc = smem_desc(sQ + wg * 64 * D * 2, 128, 16 * D);

  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};  // running max of t
  float l[2] = {0.f, 0.f};
  const float c = (p.softcap > 0.f ? 1.f : p.scale) * LOG2E;

  // Block kb's K tile in shared memory, its V tile TILE bytes on, once it
  // has landed.
  auto next_block = [&](int kb) {
    const int j = kb - kb0, stage = j % STAGES;
    mbar_wait(bars + 8 * stage, (j / STAGES) & 1);
    fence_proxy_async();
    return sKV + stage * 2 * TILE;
  };
  // This warpgroup's products no longer read block kb's stage.
  auto release = [&](int kb) {
    mbar_arrive(bars + 8 * (STAGES + (kb - kb0) % STAGES));
  };
  // S = Q Kᵀ as one fenced stage, issued and committed: KT k-steps of 16
  // columns (256 bytes, 16 descriptor units).  K is the B operand K-major
  // (keys × D).
  auto qk = [&](uint32_t sK, float (&s)[NT][4]) {
    const uint64_t kdesc = smem_desc(sK, 128, 16 * D);
    wgmma_fence();
#pragma unroll
    for (int kt = 0; kt < KT; ++kt)
      Wgmma<WBK>::ss(s, qdesc + 16 * kt, kdesc + 16 * kt, kt);
    wgmma_commit();
  };
  // Block kb's dots s → its probabilities p in place, the running max and
  // sum updated, and corr, O's factor for the new max.
  auto softmax = [&](int kb, float (&s)[NT][4], float (&corr)[2]) {
    const int k0 = kb * WBK;
    // Blocks wholly inside the band of rows [qlo, qhi] skip the masks.
    bool inside = k0 + WBK <= p.Skv;
    if (p.causal) inside = inside && k0 + WBK - 1 <= qlo;
    if (p.window > 0) inside = inside && qhi - k0 < p.window;
    float mx[2] = {NEG_INF, NEG_INF};
    if (inside)
      score_tile<false>(p, s, qpos, k0 + 2 * t, mx);
    else
      score_tile<true>(p, s, qpos, k0 + 2 * t, mx);
    float mc[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = ex2((m[r] - m_new) * c);
      mc[r] = m_new == NEG_INF ? 0.f : -m_new * c;
      m[r] = m_new;
    }
    prob_tile(s, c, mc, rs);
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rs[r];
  };
  // p → P in bf16, in wgmma's register A layout (mma.sync's, warp by
  // warp): score tiles 2kk, 2kk + 1 are the fragment of k-step kk.
  auto pack = [&](const float (&s)[NT][4], uint32_t (&pa)[PT][4]) {
#pragma unroll
    for (int kk = 0; kk < PT; ++kk) {
      pa[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }
  };
  // O rescaled to the new max; a warp whose rows all kept theirs skips.
  auto rescale = [&](const float (&corr)[2]) {
    if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
      for (int jj = 0; jj < DT; ++jj) {
        acc[jj][0] *= corr[0];
        acc[jj][1] *= corr[0];
        acc[jj][2] *= corr[1];
        acc[jj][3] *= corr[1];
      }
    }
  };

  // Each warpgroup runs its softmax between its own two products.
  uint32_t pa[PT][4];
  float corr[2];
  for (int kb = kb0; kb < kb1; ++kb) {
    const uint32_t sK = next_block(kb);
    float s[NT][4];
    qk(sK, s);
    wgmma_wait<0>();
    pin(s);
    softmax(kb, s, corr);
    rescale(corr);
    pack(s, pa);
    pv<D>(acc, pa, sK + TILE);
    wgmma_wait<0>();
    pin(acc);
    pin(pa);
    release(kb);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    const int pos = q0 + row / G, h = h0 + row % G;
    if (pos >= q1 || h >= h1) continue;
    const float den = fmaxf(l[r], 1e-30f);
    __nv_bfloat16* orow = og + pos * q_pitch + (long long)h * D + 2 * t;
#pragma unroll
    for (int jj = 0; jj < DT; ++jj) {
      __nv_bfloat162 out = __floats2bfloat162_rn(acc[jj][2 * r] / den,
                                                 acc[jj][2 * r + 1] / den);
      *reinterpret_cast<__nv_bfloat162*>(orow + jj * 8) = out;
    }
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

template <int D>
struct SimtSmem {
  static constexpr int DP = D + 1;   // odd pitch: conflict-free columns
  static constexpr int PP = BK + 1;
  static constexpr int BYTES = (BQ * DP + BK * DP + BK * D + BQ * PP) * 4;
};

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_simt_kernel(Params p) {
  static_assert(D % 8 == 0, "head_dim must be a multiple of 8");
  constexpr int DP = SimtSmem<D>::DP;
  constexpr int PP = SimtSmem<D>::PP;
  constexpr int DJ = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ks = Qs + BQ * DP;
  float* Vs = Ks + BK * DP;
  float* Ps = Vs + BK * D;

  // Thread (ty, tx): rows ty + 16i (i < 4), keys tx + 8j (j < 8) and
  // output columns tx + 8j (j < D/8).  The 8 threads of a row are 8
  // adjacent lanes, so row reductions are three xor shuffles.
  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / p.n_rep;
  const long long q_pitch = (long long)p.H * D;
  const long long kv_pitch = (long long)(p.H / p.n_rep) * D;
  const float* qg = static_cast<const float*>(p.q) +
                    (long long)b * p.Sq * q_pitch + (long long)h * D;
  const float* kg = static_cast<const float*>(p.k) +
                    (long long)b * p.Skv * kv_pitch + (long long)hk * D;
  const float* vg = static_cast<const float*>(p.v) +
                    (long long)b * p.Skv * kv_pitch + (long long)hk * D;
  float* og = static_cast<float*>(p.o) + (long long)b * p.Sq * q_pitch +
              (long long)h * D;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    Qs[r * DP + c] = q0 + r < p.Sq ? qg[(q0 + r) * q_pitch + c] : 0.f;
  }

  float acc[4][DJ];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  int kb0, kb1;
  kv_block_range(p, q0, kb0, kb1);
  for (int kb = kb0; kb < kb1; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < p.Skv;
      Ks[r * DP + c] = in ? kg[(k0 + r) * kv_pitch + c] : 0.f;
      Vs[r * D + c] = in ? vg[(k0 + r) * kv_pitch + c] : 0.f;
    }
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = Ks[(tx + 8 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i + p.q_offset;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = score_log2(p, s[i][j], qpos, k0 + tx + 8 * j);
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float corr = exp2f(m[i] - m_new);
      m[i] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float pe = s[i][j] == NEG_INF ? 0.f : exp2f(s[i][j] - m_new);
        rs += pe;
        Ps[(ty + 16 * i) * PP + tx + 8 * j] = pe;
      }
      l[i] = l[i] * corr + rs;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * PP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float vv = Vs[c * D + tx + 8 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float lt = l[i];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    lt += __shfl_xor_sync(0xffffffffu, lt, 4);
    const int row = q0 + ty + 16 * i;
    if (row >= p.Sq) continue;
    const float den = fmaxf(lt, 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      og[row * q_pitch + tx + 8 * j] = acc[i][j] / den;
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename K>
cudaError_t launch(K kernel, int bytes, int threads, dim3 grid,
                   const Params& p, cudaStream_t s) {
  // Above 48 KB a kernel's dynamic shared memory must be allowed first;
  // the call is cheap and idempotent, so every launch makes it.
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, bytes, s>>>(p);
  return cudaGetLastError();
}

// Query heads stacked into one wgmma CTA of bm rows: the whole GQA group
// when it fits.
int wgmma_group(int n_rep, int bm) { return min(n_rep, bm); }

template <int D>
cudaError_t launch_d(int bf16, int B, Params p, cudaStream_t s) {
  if (!bf16) {
    const dim3 grid((p.Sq + BQ - 1) / BQ, p.H, B);
    return launch(flash_simt_kernel<D>, SimtSmem<D>::BYTES, THREADS, grid,
                  p, s);
  }
  if constexpr (D >= 64) {
    constexpr int BM = WgCfg<D>::BM;
    p.group = wgmma_group(p.n_rep, BM);
    const int chunks = (p.n_rep + p.group - 1) / p.group;
    const int P = BM / p.group;
    const dim3 grid((p.Sq + P - 1) / P, (p.H / p.n_rep) * chunks, B);
    return launch(flash_wgmma_kernel<D>, WgSmem<D>::BYTES, WgCfg<D>::THREADS,
                  grid, p, s);
  } else {
    const dim3 grid((p.Sq + BQ - 1) / BQ, p.H, B);
    return launch(flash_mma_kernel<D>, MmaSmem<D>::BYTES, THREADS, grid, p,
                  s);
  }
}

// out[0..6]: registers per thread, local (spill) bytes per thread, dynamic
// shared bytes per CTA, threads per CTA, resident CTAs per SM, query rows
// per CTA (the wgmma kernel's are (position, head) pairs of one GQA
// group) and keys per KV block.
template <typename K>
cudaError_t describe(K kernel, int bytes, int threads, int rows, int bk,
                     int* out) {
  cudaFuncAttributes a;
  int per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&a, kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, bytes);
  if (err != cudaSuccess) return err;
  const int vals[7] = {a.numRegs, static_cast<int>(a.localSizeBytes),
                       bytes, threads, per_sm, rows, bk};
  for (int i = 0; i < 7; ++i) out[i] = vals[i];
  return cudaSuccess;
}

template <int D>
cudaError_t describe_d(int bf16, int* out) {
  if (!bf16)
    return describe(flash_simt_kernel<D>, SimtSmem<D>::BYTES, THREADS, BQ, BK,
                    out);
  if constexpr (D >= 64) {
    return describe(flash_wgmma_kernel<D>, WgSmem<D>::BYTES,
                    WgCfg<D>::THREADS, WgCfg<D>::BM, WgSmem<D>::BK, out);
  } else {
    return describe(flash_mma_kernel<D>, MmaSmem<D>::BYTES, THREADS, BQ, BK,
                    out);
  }
}

}  // namespace

// q: (B, Sq, H, D), k and v: (B, Skv, Hkv, D), o: (B, Sq, H, D); all f32
// (bf16 == 0) or all bf16, contiguous, 16-byte aligned, on the card.
// H % Hkv == 0; D ∈ {16, 32, 64, 80, 128, 256}.  Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for a head_dim it has no
// kernel for.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int bf16, int B,
                                      int Sq, int Skv, int H, int Hkv, int D,
                                      int causal, int window, int q_offset,
                                      float scale, float softcap,
                                      void* stream) {
  const Params p{q,      k,      v,        o,     Sq,      Skv, H,
                 H / Hkv, causal, window, q_offset, scale, softcap, 1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 16: err = launch_d<16>(bf16, B, p, s); break;
    case 32: err = launch_d<32>(bf16, B, p, s); break;
    case 64: err = launch_d<64>(bf16, B, p, s); break;
    case 80: err = launch_d<80>(bf16, B, p, s); break;
    case 128: err = launch_d<128>(bf16, B, p, s); break;
    case 256: err = launch_d<256>(bf16, B, p, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The kernel that flash_attention_launch runs for (bf16, D), described
// into out[7] (see describe); returns a cudaError_t.
extern "C" int flash_attention_kernel_info(int bf16, int D, int* out) {
  cudaError_t err;
  switch (D) {
    case 16: err = describe_d<16>(bf16, out); break;
    case 32: err = describe_d<32>(bf16, out); break;
    case 64: err = describe_d<64>(bf16, out); break;
    case 80: err = describe_d<80>(bf16, out); break;
    case 128: err = describe_d<128>(bf16, out); break;
    case 256: err = describe_d<256>(bf16, out); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
