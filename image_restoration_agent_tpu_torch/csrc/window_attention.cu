// K2 of the Swin block, window_attention (replacing the attention of the
// TPU kernels image_restoration_agent_tpu/ops/pallas_attention.py:
// swin_strip_pallas, wmsa_block_pallas and wmsa_pallas; K1 is in
// csrc/swin_block.cu). See ops/swin_block.py for the blocks it serves.
//
// window_attention: every (window, head) of N = ws^2 <= 256 tokens
//   (head width <= 64), logits (q.k) * scale + bias (+ mask): scale 1 for
//   the Swin block's callers (q pre-scaled in the weights), head_dim**-0.5
//   for the TPU's wmsa_pallas contract (q unscaled, the product scaled in
//   float32; ops/swin_block.py:wmsa). The bias is the dense (heads, N, N)
//   rpb, or the ((2ws-1)^2, heads) table staged in shared memory with
//   rpb[h, i, j] rebuilt by the relative-position index rule (the same
//   values); the mask an edge bank (entries the wrapper found all zero are
//   skipped) or a full (nW, N, N) mask.
//   - bfloat16 (window_attention_mma_kernel): mma.sync m16n8k16 with the
//     16 x N logits of a warp's 16 query rows in registers; the softmax
//     runs on the accumulators and p, rounded to bf16, is PV's A fragment
//     (no logits in shared memory). N <= 64: one block per window stages
//     the window's contiguous run of N x 3C (every head) with one sweep of
//     16-byte cp.async; N > 64: one block per (window, head) stages its
//     q, k, v once for all 4 warps.
//   - float32: both products in split TF32 on mma.sync m16n8k8 (x = xh +
//     xl in registers, xl yh + xh yl + xh yh summed in float32), the
//     logits, softmax and p in registers in float32 (p's A fragment is S's
//     accumulator, PV's keys taken in a permuted order), the normalization
//     applied to O. N > 64 (window_attention_tf32_kernel): the bf16 warp
//     pairs; one block per (window, head) stages k and v once, the query
//     rows in 64-row chunks, split across blocks where the windows are too
//     few to fill the card. N <= 64 (window_attention_tf32_stream_kernel):
//     a warp a row block over all the keys; persistent blocks, each on one
//     group of heads, stage the next window while computing one.
//
// Plain C interface for ctypes; each entry returns cudaGetLastError().

#include <algorithm>
#include <type_traits>

#include "common.cuh"
#include "sm90_gemm.cuh"

using namespace irk;

namespace {

constexpr int MAXN = 256;             // tokens per window
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kExp2Clamp = 86.56f;  // 60 * log2(e): the TPU kernel's clamp

__host__ __device__ constexpr size_t align16(size_t v) {
  return (v + 15) / 16 * 16;
}

struct Attn {
  const void* qkv;        // (nwin * N, 3C) window-order rows
  const float* rpb;       // dense (heads, N, N), or nullptr in table mode
  const float* table;     // ((2ws-1)^2, heads) bias table, or nullptr
  const float* bank;      // (2, 2, N, N) edge bank, or nullptr
  const float* mask;      // (nmask, N, N) full mask, or nullptr
  const uint32_t* bits;   // the bank's or mask's bit form, or nullptr
  void* out;              // (nwin * N, C)
  int nmask, n, C, heads, nwy, nwx, ws, fast, bank_zero, mw;
  float scale, mval;
};

// The entry of the mask (or bank) that window `win` adds, or -1: mask[win
// % nmask] in full-mask mode; in bank mode bank[is_last_window_row,
// is_last_window_col], or -1 where bit `sel` of bank_zero says that entry
// is all zero (adding +0.0 changes no logit).
__device__ __forceinline__ int mask_entry(const Attn& a, long long win) {
  if (a.mask != nullptr) return static_cast<int>(win % a.nmask);
  if (a.bank == nullptr) return -1;
  const int wx = static_cast<int>(win % a.nwx);
  const int wy = static_cast<int>((win / a.nwx) % a.nwy);
  const int sel = (wy == a.nwy - 1) * 2 + (wx == a.nwx - 1);
  return (a.bank_zero >> sel) & 1 ? -1 : sel;
}

// The additive mask of one query row (rows past N read row N - 1: never
// stored). With the bit form (a.bits: bit j of word j / 32 of a row set
// where the entry holds a.mval, 0 elsewhere; a.mw words a row) the row's
// words come from `wrow` (shared memory, or device memory); otherwise the
// dense float32 row.
struct MaskRow {
  const uint32_t* w;
  const float* d;
  float val;
};

__device__ __forceinline__ MaskRow mask_row(const Attn& a, int entry,
                                            const uint32_t* staged, int i) {
  if (entry < 0) return MaskRow{nullptr, nullptr, 0.f};
  i = min(i, a.n - 1);
  if (a.bits != nullptr)
    return MaskRow{staged != nullptr
                       ? staged + i * a.mw
                       : a.bits + (static_cast<long long>(entry) * a.n + i) *
                                      a.mw,
                   nullptr, a.mval};
  const float* m = a.mask != nullptr ? a.mask : a.bank;
  return MaskRow{nullptr, m + (static_cast<long long>(entry) * a.n + i) * a.n,
                 0.f};
}

// the window's bit rows into shared memory (n * mw words), when it has any
__device__ __forceinline__ const uint32_t* stage_bits(const Attn& a,
                                                      int entry,
                                                      uint32_t* dst) {
  if (entry < 0 || a.bits == nullptr) return nullptr;
  const uint32_t* src =
      a.bits + static_cast<long long>(entry) * a.n * a.mw;
  for (int e = threadIdx.x; e < a.n * a.mw; e += blockDim.x)
    cp_async4(dst + e, src + e);
  return dst;
}

// The relative-position bias of one query row at key column cb[j]. Table
// mode rebuilds rpb[h, i, j] = table[(yi - yj + ws - 1)(2ws - 1) + xi - xj
// + ws - 1, h] from the table staged in shared memory as tab[L][hb]:
// tab[(rb(i) - cb(j)) * hb + hl]; dense mode reads rpb[h, i, j] (cb(j) =
// j) from device memory.
struct BiasRow {
  const float* p;
  int stride;
  __device__ __forceinline__ float operator()(int cbj) const {
    return p[cbj * stride];
  }
};

// Table mode at window 16 (HAT), one head a block: for row i = r0 + g +
// 8 r (r0 a multiple of 16, so yi = r0 / 16, xi = g + 8 r) and key j = j0 +
// 8 nt + 2 t + e, table index = base(i, t, j0) - (31 (nt / 2) + 8 (nt % 2)
// + e): one shared load with a constant offset a logit.
struct BiasRow16 {
  const float* p;
  template <int NT8, int E>
  __device__ __forceinline__ float at() const {
    return p[-(31 * (NT8 >> 1) + 8 * (NT8 & 1) + E)];
  }
};

__device__ __forceinline__ BiasRow16 bias_row16(const float* tab, int r0,
                                                int r, int g, int t,
                                                int j0) {
  return BiasRow16{tab + (r0 / 16 + 15 - j0 / 16) * 31 + 15 + g + 8 * r -
                   2 * t};
}

__device__ __forceinline__ BiasRow bias_row(const Attn& a, const float* tab,
                                            int hb, int hl, int h, int i) {
  if (i >= a.n) i = 0;  // a padding query row: any row (never stored)
  if (a.table != nullptr) {
    const int w2 = 2 * a.ws - 1;
    const int rb = (i / a.ws + a.ws - 1) * w2 + i % a.ws + a.ws - 1;
    return BiasRow{tab + rb * hb + hl, -hb};
  }
  return BiasRow{a.rpb + (static_cast<long long>(h) * a.n + i) * a.n, 1};
}

// cb[j] for the block's np key columns (0 past N: those logits are -inf)
__device__ __forceinline__ void bias_cols(const Attn& a, int* cb, int np) {
  for (int j = threadIdx.x; j < np; j += blockDim.x)
    cb[j] = j >= a.n ? 0
            : a.table != nullptr ? (j / a.ws) * (2 * a.ws - 1) + j % a.ws
                                 : j;
}

// the table's columns of heads h0 .. h0 + hb - 1 as tab[L][hb]
__device__ __forceinline__ void stage_table(const Attn& a, float* tab, int h0,
                                            int hb) {
  if (a.table == nullptr) return;
  const int w2 = 2 * a.ws - 1, len = w2 * w2 * hb;
  for (int e = threadIdx.x; e < len; e += blockDim.x)
    tab[e] = a.table[(e / hb) * a.heads + h0 + e % hb];
}

__device__ __forceinline__ int table_len(const Attn& a) {
  return a.table != nullptr ? (2 * a.ws - 1) * (2 * a.ws - 1) : 0;
}

// 2^x for the fast softmax: the MUFU instruction alone, subnormal results
// flushed to 0 (exp2f's subnormal handling cost 6% of K2; a p below 2^-126
// of its row's sum is 0 in either form once normalized and rounded)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Softmax of the rows a thread holds, in place: cnt values a thread, the
// row spread over the lanes whose ids differ in the bits of `lanes` (xor
// shuffles). Fast: base-2 logits, clamp instead of max subtraction,
// reciprocal normalization; exact: max-subtracted, divided. Returns the
// row's sum; NORM false leaves the values unnormalized (the caller divides
// by the sum).
template <int CNT, bool NORM = true>
__device__ __forceinline__ float row_softmax(float* v, bool fast,
                                             int lanes) {
  float s = 0.f;
  if (fast) {
#pragma unroll
    for (int k = 0; k < CNT; ++k) {
      v[k] = fast_exp2(fminf(v[k], kExp2Clamp));
      s += v[k];
    }
    for (int o = 1; o <= lanes; o <<= 1)
      s += __shfl_xor_sync(0xffffffffu, s, o);
    if (!NORM) return s;
    const float inv = 1.f / s;
#pragma unroll
    for (int k = 0; k < CNT; ++k) v[k] *= inv;
  } else {
    float m = v[0];
#pragma unroll
    for (int k = 1; k < CNT; ++k) m = fmaxf(m, v[k]);
    for (int o = 1; o <= lanes; o <<= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
#pragma unroll
    for (int k = 0; k < CNT; ++k) {
      v[k] = expf(v[k] - m);
      s += v[k];
    }
    for (int o = 1; o <= lanes; o <<= 1)
      s += __shfl_xor_sync(0xffffffffu, s, o);
    if (!NORM) return s;
#pragma unroll
    for (int k = 0; k < CNT; ++k) v[k] /= s;
  }
  return s;
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// q's A fragments of rows r0 + g and r0 + g + 8, masked past column hd
template <int KD>
__device__ __forceinline__ void q_frags(uint32_t (&qa)[KD][4],
                                        const __nv_bfloat16* Q, int ld,
                                        int hd, int r0, int g, int t) {
  const __nv_bfloat16* q0 = Q + (r0 + g) * ld;
  const __nv_bfloat16* q1 = q0 + 8 * ld;
#pragma unroll
  for (int kd = 0; kd < KD; ++kd) {
    const int c = 16 * kd + 2 * t;
    qa[kd][0] = c < hd ? ld32(q0 + c) : 0u;
    qa[kd][1] = c < hd ? ld32(q1 + c) : 0u;
    qa[kd][2] = c + 8 < hd ? ld32(q0 + c + 8) : 0u;
    qa[kd][3] = c + 8 < hd ? ld32(q1 + c + 8) : 0u;
  }
}

// f(integral_constant<I>), ..., f(integral_constant<NT - 1>)
template <int I, int NT>
struct Unroll {
  template <typename F>
  __device__ __forceinline__ static void run(F&& f) {
    f(std::integral_constant<int, I>{});
    Unroll<I + 1, NT>::run(f);
  }
};
template <int NT>
struct Unroll<NT, NT> {
  template <typename F>
  __device__ __forceinline__ static void run(F&&) {}
};

// The logits of S tiles in the mma accumulator layout (rows g and g + 8,
// keys j0 + 8 nt + 2t and + 1), in place: ((q.k) * scale + bias) + mask,
// times ls (log2 e in fast mode), -inf past N. mw[r][k]: word k (keys j0 +
// 32 k ..) of row r's mask bits (bits form), or the dense rows m0.d, m1.d;
// neither where the window has no mask. W16: the bias comes from the
// window-16 rows w0, w1 (BiasRow16) rather than from b0, b1 and cb.
template <int NT, bool W16>
__device__ __forceinline__ void logit_epilogue(
    float (&s)[NT][4], int n, int j0, const BiasRow& b0, const BiasRow& b1,
    const MaskRow& m0, const MaskRow& m1, const uint32_t (&mw)[2][NT / 4],
    const int* cb, float scale, float ls, int t, const BiasRow16& w0,
    const BiasRow16& w1) {
  Unroll<0, NT>::run([&](auto ntc) {
    constexpr int nt = decltype(ntc)::value;
    const int jw = j0 + 8 * nt;  // the first key of the tile
    const uint32_t mb0 = mw[0][nt >> 2] >> (8 * (nt & 3) + 2 * t);
    const uint32_t mb1 = mw[1][nt >> 2] >> (8 * (nt & 3) + 2 * t);
    Unroll<0, 2>::run([&](auto ec) {
      constexpr int e = decltype(ec)::value;
      const int j = jw + 2 * t + e;
      float v0 = -INFINITY, v1 = -INFINITY;
      if (j < n) {
        float c0, c1;
        if constexpr (W16) {
          c0 = w0.template at<nt, e>();
          c1 = w1.template at<nt, e>();
        } else {
          const int cj = cb[j];
          c0 = b0(cj);
          c1 = b1(cj);
        }
        float k0 = 0.f, k1 = 0.f;
        if (m0.w != nullptr) {
          k0 = (mb0 >> e) & 1u ? m0.val : 0.f;
          k1 = (mb1 >> e) & 1u ? m1.val : 0.f;
        } else if (m0.d != nullptr) {
          k0 = m0.d[j];
          k1 = m1.d[j];
        }
        v0 = ((s[nt][e] * scale + c0) + k0) * ls;
        v1 = ((s[nt][2 + e] * scale + c1) + k1) * ls;
      }
      s[nt][e] = v0;
      s[nt][2 + e] = v1;
    });
  });
}

// bf16: S = q k^T (NT n8 tiles of keys j0 ..), then logit_epilogue
template <int NT, int KD, bool W16 = false>
__device__ __forceinline__ void logits(
    float (&s)[NT][4], const uint32_t (&qa)[KD][4],
    const __nv_bfloat16* K, int ld, int hd, int n, int j0, const BiasRow& b0,
    const BiasRow& b1, const MaskRow& m0, const MaskRow& m1,
    const uint32_t (&mw)[2][NT / 4], const int* cb, float scale, float ls,
    int g, int t, const BiasRow16& w0 = BiasRow16{nullptr},
    const BiasRow16& w1 = BiasRow16{nullptr}) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    if (j0 + 8 * nt >= n) continue;
    const __nv_bfloat16* kr = K + (j0 + 8 * nt + g) * ld;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      const int c = 16 * kd + 2 * t;
      mma_bf16(s[nt], qa[kd], c < hd ? ld32(kr + c) : 0u,
               c + 8 < hd ? ld32(kr + c + 8) : 0u);
    }
  }
  logit_epilogue<NT, W16>(s, n, j0, b0, b1, m0, m1, mw, cb, scale, ls, t, w0,
                          w1);
}

// O (+)= p v for the 16 keys at row j of V; p's A fragment from S tiles
// 2 kk and 2 kk + 1. v through ldmatrix.trans where its rows are 16-byte
// aligned (TRANS), else pairwise.
template <int KD, bool TRANS>
__device__ __forceinline__ void pv_step(float (&acc)[2 * KD][4],
                                        const uint32_t (&pa)[4],
                                        const __nv_bfloat16* V, int ld, int j,
                                        int lane) {
  if constexpr (TRANS) {
    const __nv_bfloat16* vr =
        V + (j + (lane & 7) + 8 * ((lane >> 3) & 1)) * ld + 8 * (lane >> 4);
#pragma unroll
    for (int nd2 = 0; nd2 < KD; ++nd2) {
      uint32_t r[4];
      ldmatrix_x4_trans(r, vr + 16 * nd2);
      mma_bf16(acc[2 * nd2], pa, r[0], r[1]);
      mma_bf16(acc[2 * nd2 + 1], pa, r[2], r[3]);
    }
  } else {
    const int g = lane >> 2, t = lane & 3;
    const __nv_bfloat16* vr = V + (j + 2 * t) * ld;
#pragma unroll
    for (int nd = 0; nd < 2 * KD; ++nd) {
      const int c = 8 * nd + g;
      mma_bf16(acc[nd], pa, pack_bf16(vr[c], vr[ld + c]),
               pack_bf16(vr[8 * ld + c], vr[9 * ld + c]));
    }
  }
}

template <int KD>
__device__ __forceinline__ void store_rows(const float (&acc)[2 * KD][4],
                                           __nv_bfloat16* o, int C, int hd,
                                           int n, int r0, int g, int t) {
#pragma unroll
  for (int nd = 0; nd < 2 * KD; ++nd) {
    const int c = 8 * nd + 2 * t;
    if (c >= hd) continue;
    if (r0 + g < n)
      *reinterpret_cast<uint32_t*>(o + (r0 + g) * C + c) =
          pack_bf16(acc[nd][0], acc[nd][1]);
    if (r0 + g + 8 < n)
      *reinterpret_cast<uint32_t*>(o + (r0 + g + 8) * C + c) =
          pack_bf16(acc[nd][2], acc[nd][3]);
  }
}

// bf16, N <= 64: one warp's 16 query rows r0 .. of one head in one pass:
// the whole 16 x 64 logits block in registers, the softmax on the
// accumulators, p rounded to bf16 straight into PV's A fragments (S's
// accumulator layout is PV's A layout).
template <int KD>
__device__ __forceinline__ void attn_rows64(
    const __nv_bfloat16* Q, const __nv_bfloat16* K, const __nv_bfloat16* V,
    int ld, int hd, int n, int r0, const BiasRow& b0, const BiasRow& b1,
    const MaskRow& m0, const MaskRow& m1, const uint32_t (&mw)[2][2],
    const int* cb, float scale, bool fast, __nv_bfloat16* o, int C,
    int lane) {
  const int g = lane >> 2, t = lane & 3;
  uint32_t qa[KD][4];
  q_frags<KD>(qa, Q, ld, hd, r0, g, t);
  float s[8][4];
  logits<8, KD>(s, qa, K, ld, hd, n, 0, b0, b1, m0, m1, mw, cb, scale,
                fast ? kLog2e : 1.f, g, t);
  float r0v[16], r1v[16];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    r0v[2 * nt] = s[nt][0];
    r0v[2 * nt + 1] = s[nt][1];
    r1v[2 * nt] = s[nt][2];
    r1v[2 * nt + 1] = s[nt][3];
  }
  row_softmax<16>(r0v, fast, 2);
  row_softmax<16>(r1v, fast, 2);
  float acc[2 * KD][4];
#pragma unroll
  for (int nd = 0; nd < 2 * KD; ++nd)
    acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (16 * kk >= n) continue;
    const uint32_t pa[4] = {pack_bf16(r0v[4 * kk], r0v[4 * kk + 1]),
                            pack_bf16(r1v[4 * kk], r1v[4 * kk + 1]),
                            pack_bf16(r0v[4 * kk + 2], r0v[4 * kk + 3]),
                            pack_bf16(r1v[4 * kk + 2], r1v[4 * kk + 3])};
    pv_step<KD, false>(acc, pa, V, ld, 16 * kk, lane);
  }
  store_rows<KD>(acc, o, C, hd, n, r0, g, t);
}

__device__ __forceinline__ void pair_sync(int id) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(id) : "memory");
}

// The softmax of a warp pair's 16 rows, in place on S, each warp holding
// the NT n8 tiles of its key half kh: the pair exchanges its row statistics
// through shared memory (xs, 16 x 2 floats a statistic) under named barrier
// `bar` (exact mode: the row maxima, then the sums; fast: the sums). Both
// warps sum the two halves as a + b and b + a: the same value, so p is the
// same as one warp's would be. NORM false leaves p unnormalized (exp(s -
// max), or the fast form's exp2) and l[r] the sums of rows g and g + 8: the
// caller divides O's rows by them (exact; fast: times 1 / l), 4 ND
// divisions a thread rather than one a logit.
template <int NT, bool NORM = true>
__device__ __forceinline__ void pair_softmax(float (&s)[NT][4], bool fast,
                                             int kh, int g, int t, float* xs,
                                             int bar, float (&l)[2]) {
  // this half's row statistic, over the quad, then with the other half
  auto exchange = [&](float (&v)[2], bool is_max, float* slot) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int x = 1; x <= 2; x <<= 1) {
        const float w = __shfl_xor_sync(0xffffffffu, v[r], x);
        v[r] = is_max ? fmaxf(v[r], w) : v[r] + w;
      }
    if (t == 0) {
      slot[kh * 16 + g] = v[0];
      slot[kh * 16 + g + 8] = v[1];
    }
    pair_sync(bar);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float w = slot[(1 - kh) * 16 + g + 8 * r];
      v[r] = is_max ? fmaxf(v[r], w) : v[r] + w;
    }
  };
  l[0] = l[1] = 0.f;
  if (fast) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = fast_exp2(fminf(s[nt][e], kExp2Clamp));
        l[e >> 1] += s[nt][e];
      }
    exchange(l, false, xs);
    if (!NORM) return;
    const float inv[2] = {1.f / l[0], 1.f / l[1]};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] *= inv[e >> 1];
  } else {
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
    exchange(mx, true, xs);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = expf(s[nt][e] - mx[e >> 1]);
        l[e >> 1] += s[nt][e];
      }
    exchange(l, false, xs + 32);
    if (!NORM) return;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] /= l[e >> 1];
  }
}

// The pair's partial O summed: warp kh 1 hands its float32 partial to warp
// kh 0 through shared memory (xo) under named barrier `bar`; true for the
// warp that then holds the sum (and stores the rows).
template <int ND>
__device__ __forceinline__ bool pair_sum(float (&acc)[ND][4], int kh,
                                         int lane, float* xo, int bar) {
  if (kh == 1) {
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) xo[(nd * 4 + e) * 32 + lane] = acc[nd][e];
  }
  pair_sync(bar);
  if (kh == 0) {
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nd][e] += xo[(nd * 4 + e) * 32 + lane];
  }
  return kh == 0;
}

// bf16, N > 64: 16 query rows r0 .. of one head shared by a warp pair, in
// one pass: the warp of key half kh takes keys kh NP/2 .. +NP/2 (16 x NP/2
// logits, NP/4 registers a thread), and the two exchange through shared
// memory (xs, 16 x 2 floats a statistic; xo, the PV partials) under a
// named barrier: the row sums (exact mode: the row maxima, then the sums),
// after which each normalizes its own p in float32, rounds it to bf16
// into PV's A fragments and multiplies by its half of v; warp kh 1 hands
// its float32 partial O to warp kh 0, which adds it and stores the rows
// (pair_softmax, pair_sum).
template <int NP, int KD, bool W16>
__device__ __forceinline__ void attn_rows_pair(
    const __nv_bfloat16* Q, const __nv_bfloat16* K, const __nv_bfloat16* V,
    int ld, int hd, int n, int r0, int kh, const BiasRow& b0,
    const BiasRow& b1, const MaskRow& m0, const MaskRow& m1, const int* cb,
    float scale, bool fast, __nv_bfloat16* o, int C, int lane, float* xs,
    float* xo, int bar) {
  constexpr int NT = NP / 16;  // n8 tiles in a half
  const int g = lane >> 2, t = lane & 3, j0 = kh * (NP / 2);
  uint32_t qa[KD][4];
  q_frags<KD>(qa, Q, ld, hd, r0, g, t);
  uint32_t mw[2][NT / 4];
#pragma unroll
  for (int k = 0; k < NT / 4; ++k) {
    mw[0][k] = m0.w != nullptr ? m0.w[(j0 >> 5) + k] : 0u;
    mw[1][k] = m1.w != nullptr ? m1.w[(j0 >> 5) + k] : 0u;
  }
  float s[NT][4];
  if constexpr (W16)
    logits<NT, KD, true>(s, qa, K, ld, hd, n, j0, b0, b1, m0, m1, mw, cb,
                         scale, fast ? kLog2e : 1.f, g, t,
                         bias_row16(b0.p, r0, 0, g, t, j0),
                         bias_row16(b0.p, r0, 1, g, t, j0));
  else
    logits<NT, KD>(s, qa, K, ld, hd, n, j0, b0, b1, m0, m1, mw, cb, scale,
                   fast ? kLog2e : 1.f, g, t);
  float l[2];
  pair_softmax<NT>(s, fast, kh, g, t, xs, bar, l);
  float acc[2 * KD][4];
#pragma unroll
  for (int nd = 0; nd < 2 * KD; ++nd)
    acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    if (j0 + 16 * kk >= n) continue;
    const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                            pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                            pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                            pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
    pv_step<KD, true>(acc, pa, V, ld, j0 + 16 * kk, lane);
  }
  if (pair_sum<2 * KD>(acc, kh, lane, xo, bar))
    store_rows<KD>(acc, o, C, hd, n, r0, g, t);
}

// bf16 kernel, KD (head width padded to 16 KD) a template argument, so S
// and the output accumulators are register arrays; 8 warps a block.
//   - N <= 64 (NP 64): one block per window. The window's N rows of 3C
//     are one contiguous run in device memory: one cp.async sweep of 16-,
//     8- or 4-byte copies (the widest the run's address and length allow)
//     stages q, k and v of every head at once; warp w takes query rows
//     16 (w % 4) .. +15 of heads w / 4, w / 4 + 2, ..., one pass each
//     (attn_rows64), its rows' mask words read once for all of them. v's
//     pairs are read element-wise (a head slice need not be 16-byte
//     aligned).
//   - N > 64 (NP 128, 256): one block per (window, head) stages the head's
//     q, k, v once for all 8 warps (cp.async: 8-byte copies of the aligned
//     run holding a slice where the rows allow, else 4-byte copies) into
//     tiles of pitch 16 KD + 8, and the
//     window's mask bits; warps w and w + 4 take row blocks w % 4,
//     w % 4 + 4, ..., each one half of the keys (attn_rows_pair); v
//     through ldmatrix.trans.
// Rows past N of v are zero (p is 0 there, but 0 x garbage could be NaN).
template <int NP, int KD, bool W16 = false>
__global__ void __launch_bounds__(256, 2)
    window_attention_mma_kernel(const Attn a) {
  extern __shared__ __align__(16) unsigned char smem[];
  using bf = __nv_bfloat16;
  constexpr int NTH = 256;
  const int C = a.C, c3 = 3 * C, n = a.n, hd = C / a.heads;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2;
  const bf* qkv = static_cast<const bf*>(a.qkv);
  bf* out = static_cast<bf*>(a.out);
  long long win;
  int h0, hb, ld;
  int sh[3] = {0, 0, 0};  // q's and k's first element in their tile rows
  bf* Qs;
  float* tab;
  if constexpr (NP == 64) {
    win = blockIdx.x;
    h0 = 0;
    hb = a.heads;
    ld = c3;
    Qs = reinterpret_cast<bf*>(smem);
    tab = reinterpret_cast<float*>(smem + align16(64 * c3 * 2 + 64));
    const char* src = reinterpret_cast<const char*>(qkv + win * n * c3);
    char* dst = reinterpret_cast<char*>(Qs);
    const int bytes = n * c3 * 2;
    const int al = static_cast<int>(reinterpret_cast<uintptr_t>(src)) | bytes;
    const int w = al & 15 ? (al & 7 ? 4 : 8) : 16;
    for (int o = tid * w; o < bytes; o += NTH * w)
      cp_async_w(dst + o, src + o, w);
    for (int o = bytes + tid * 4; o < 64 * c3 * 2; o += NTH * 4)
      *reinterpret_cast<uint32_t*>(dst + o) = 0u;
  } else {
    win = blockIdx.x / a.heads;
    h0 = static_cast<int>(blockIdx.x % a.heads);
    hb = 1;
    ld = 16 * KD + 8;
    Qs = reinterpret_cast<bf*>(smem);
    tab = reinterpret_cast<float*>(Qs + 3 * NP * ld);
    // per section (q, k, v): 8-byte copies of the 8-byte-aligned run that
    // holds the head's slice where the rows are 8-byte aligned (q's and
    // k's data may then start sh = 2 elements into their tile rows; v's
    // rows stay 16-byte aligned for ldmatrix, so v takes this only from an
    // aligned start), else 4-byte copies of the slice; a run never reads
    // past the tensor (v of the last head stays exact)
    const bf* src = qkv + win * n * c3 + h0 * hd;
    const bool rows8 =
        ((reinterpret_cast<uintptr_t>(qkv) | (6 * C)) & 7) == 0;
#pragma unroll
    for (int which = 0; which < 3; ++which) {
      const bf* s0 = src + which * C;
      const int lead = static_cast<int>(reinterpret_cast<uintptr_t>(s0) & 7);
      const int bytes = lead + 2 * hd, n8 = (bytes + 7) / 8;
      const bool tail = which == 2 && h0 == a.heads - 1 && n8 * 8 > bytes;
      const bool wide = rows8 && !tail && (which < 2 || lead == 0);
      sh[which] = wide ? lead / 2 : 0;
      bf* dst = Qs + which * NP * ld;
      if (wide) {
        const char* s8 = reinterpret_cast<const char*>(s0) - lead;
        for (int e = tid; e < n * n8; e += NTH) {
          const int i = e / n8, sg = e - i * n8;
          cp_async8z(reinterpret_cast<char*>(dst + i * ld) + 8 * sg,
                     s8 + static_cast<long long>(i) * c3 * 2 + 8 * sg, 8);
        }
      } else {
        const int n4 = hd / 2;
        for (int e = tid; e < n * n4; e += NTH) {
          const int i = e / n4, sg = e - i * n4;
          cp_async4(dst + i * ld + 2 * sg,
                    s0 + static_cast<long long>(i) * c3 + 2 * sg);
        }
      }
    }
    uint32_t* vz = reinterpret_cast<uint32_t*>(Qs + (2 * NP + n) * ld);
    for (int e = tid; e < (NP - n) * ld / 2; e += NTH) vz[e] = 0u;
  }
  int* cb = reinterpret_cast<int*>(tab + table_len(a) * hb);
  const int entry = mask_entry(a, win);
  const uint32_t* mb =
      NP == 64 ? nullptr : stage_bits(a, entry, reinterpret_cast<uint32_t*>(
                                                    cb + NP));
  stage_table(a, tab, h0, hb);
  bias_cols(a, cb, NP);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const long long base = win * n;
  if constexpr (NP == 64) {
    const int r0 = 16 * (warp & 3);
    if (r0 >= n) return;
    // the two rows' mask, read once for every head: the bit words, or the
    // dense rows copied into a register-resident form
    const MaskRow m0 = mask_row(a, entry, nullptr, r0 + g);
    const MaskRow m1 = mask_row(a, entry, nullptr, r0 + g + 8);
    uint32_t mw[2][2] = {{0u, 0u}, {0u, 0u}};
    if (m0.w != nullptr)
#pragma unroll
      for (int k = 0; k < 2; ++k)
        if (k < a.mw) {
          mw[0][k] = m0.w[k];
          mw[1][k] = m1.w[k];
        }
    for (int h = warp >> 2; h < a.heads; h += 2)
      attn_rows64<KD>(Qs + h * hd, Qs + C + h * hd, Qs + 2 * C + h * hd, ld,
                      hd, n, r0, bias_row(a, tab, hb, h, h, r0 + g),
                      bias_row(a, tab, hb, h, h, r0 + g + 8), m0, m1, mw, cb,
                      a.scale, a.fast, out + base * C + h * hd, C, lane);
  } else {
    // warps w and w + 4 share row blocks w % 4, w % 4 + 4, ...
    const int pair = warp & 3, kh = warp >> 2;
    float* xs = reinterpret_cast<float*>(
        reinterpret_cast<uint32_t*>(cb + NP) + n * a.mw) + pair * (64 + 256 * KD);
    for (int r0 = 16 * pair; r0 < n; r0 += 64)
      attn_rows_pair<NP, KD, W16>(
          Qs + sh[0], Qs + NP * ld + sh[1], Qs + 2 * NP * ld, ld, hd, n, r0,
          kh,
          W16 ? BiasRow{tab, 0} : bias_row(a, tab, hb, 0, h0, r0 + g),
          W16 ? BiasRow{tab, 0} : bias_row(a, tab, hb, 0, h0, r0 + g + 8),
          mask_row(a, entry, mb, r0 + g), mask_row(a, entry, mb, r0 + g + 8),
          cb, a.scale, a.fast, out + base * C + h0 * hd, C, lane, xs,
          xs + 64, 1 + pair);
  }
}

size_t attention_mma_smem(int np, int kd, int C, int heads, int L, int n,
                          int mw) {
  if (np == 64)
    return align16(static_cast<size_t>(64) * 3 * C * 2 + 64) +
           (static_cast<size_t>(L) * heads + 64) * 4;
  return static_cast<size_t>(3) * np * (16 * kd + 8) * 2 +
         (static_cast<size_t>(L) + np + static_cast<size_t>(n) * mw +
          4 * (64 + 256 * static_cast<size_t>(kd))) *
             4;
}

// ---------------------------------------------------------------------------
// K2 float32: split TF32 on mma.sync m16n8k8

// the split-TF32 helpers (mma_tf32, split1, split_a, mma_split) are
// common.cuh's

// float32, 16 query rows (r0 .., Q pointing at row r0 of the staged tile)
// of one head shared by a warp pair as in attn_rows_pair, both products in
// split TF32: S = q k^T as ql kh + qh kl + qh kh a k step of 8 head
// columns, the logits and the softmax in float32 on the accumulators
// (logit_epilogue, pair_softmax), then O = p v as pl vh + ph vl + ph vh a
// step of 8 keys with p unnormalized, O's rows divided by the row sums at
// the end (times their reciprocal when fast). PV's k step takes S tile
// nt's keys in the order 2t, 2t + 1 -> k t, t + 4, so p's A fragment is
// S's accumulator as it stands (no shuffle) and v's B fragment reads key
// rows 2t and 2t + 1. The tile pitch ld = 8 ND + 4 makes every fragment
// load conflict-free.
template <int NP, int ND, bool W16>
__device__ __forceinline__ void attn_rows_tf32(
    const float* Q, const float* K, const float* V, int ld, int hd, int n,
    int r0, int kh, const BiasRow& b0, const BiasRow& b1, const MaskRow& m0,
    const MaskRow& m1, const int* cb, float scale, bool fast, float* o,
    int C, int lane, float* xs, float* xo, int bar) {
  constexpr int NT = NP / 16;  // n8 tiles in a half
  const int g = lane >> 2, t = lane & 3, j0 = kh * (NP / 2);
  uint32_t mw[2][NT / 4];
#pragma unroll
  for (int k = 0; k < NT / 4; ++k) {
    mw[0][k] = m0.w != nullptr ? m0.w[(j0 >> 5) + k] : 0u;
    mw[1][k] = m1.w != nullptr ? m1.w[(j0 >> 5) + k] : 0u;
  }
  float s[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
  for (int kd = 0; kd < ND; ++kd) {
    const float* qr = Q + g * ld + 8 * kd + t;
    uint32_t qh[4], ql[4];
    split_a(qr[0], qr[8 * ld], qr[4], qr[8 * ld + 4], qh, ql);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (j0 + 8 * nt >= n) continue;
      const float* kr = K + (j0 + 8 * nt + g) * ld + 8 * kd + t;
      mma_split(s[nt], qh, ql, kr[0], kr[4]);
    }
  }
  const float ls = fast ? kLog2e : 1.f;
  if constexpr (W16)
    logit_epilogue<NT, true>(s, n, j0, b0, b1, m0, m1, mw, cb, scale, ls, t,
                             bias_row16(b0.p, r0, 0, g, t, j0),
                             bias_row16(b0.p, r0, 1, g, t, j0));
  else
    logit_epilogue<NT, false>(s, n, j0, b0, b1, m0, m1, mw, cb, scale, ls, t,
                              BiasRow16{nullptr}, BiasRow16{nullptr});
  float l[2];
  pair_softmax<NT, false>(s, fast, kh, g, t, xs, bar, l);
  float acc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
    acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    if (j0 + 8 * nt >= n) continue;
    uint32_t ph[4], pl[4];
    split_a(s[nt][0], s[nt][2], s[nt][1], s[nt][3], ph, pl);
    const float* vr = V + (j0 + 8 * nt + 2 * t) * ld + g;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
      mma_split(acc[nd], ph, pl, vr[8 * nd], vr[ld + 8 * nd]);
  }
  if (pair_sum<ND>(acc, kh, lane, xo, bar)) {
    const float inv[2] = {1.f / l[0], 1.f / l[1]};
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = r0 + g + 8 * (e >> 1), c = 8 * nd + 2 * t + (e & 1);
        if (i < n && c < hd)
          o[i * C + c] =
            fast ? acc[nd][e] * inv[e >> 1] : acc[nd][e] / l[e >> 1];
      }
  }
}

// float32 kernel, N > 64, ND (head width padded to 8 ND) a template
// argument; 8 warps a block. One block per (window, head, part): the head's
// k and v are
// staged once (cp.async of 16, 8 or 4 bytes as the slice allows) into tiles
// of pitch 8 ND + 4, with the window's mask bits and the head's bias table;
// the query rows, in chunks of 64, go to a 64-row tile, where warps w and w
// + 4 take the chunk's row block w % 4, each one half of the keys
// (attn_rows_tf32). A (window, head) whose 64-row chunks are more than one
// may split them across `parts` blocks (part p takes chunks p, p + parts,
// ...), so that few windows still fill the card. Columns hd .. 8 ND of q
// and k enter the products: zero; rows past N of v meet p = 0: zero.
// Shared memory at NP 256, head width 30: 105 KB, two blocks an SM.
template <int NP, int ND, bool W16 = false>
__global__ void __launch_bounds__(256, 2)
    window_attention_tf32_kernel(const Attn a, int parts) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int LD = 8 * ND + 4, XS = 64 + 128 * ND;
  const int C = a.C, c3 = 3 * C, n = a.n, hd = C / a.heads;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2;
  const long long wh = blockIdx.x / parts;
  const int part = static_cast<int>(blockIdx.x - wh * parts);
  const long long win = wh / a.heads;
  const int h = static_cast<int>(wh - win * a.heads);
  float* Qs = reinterpret_cast<float*>(smem);  // [64][LD]
  float* Ks = Qs + 64 * LD;                    // [NP][LD]
  float* Vs = Ks + NP * LD;                    // [NP][LD]
  float* xs = Vs + NP * LD;                    // [4][XS]: a pair's exchange
  float* tab = xs + 4 * XS;
  int* cb = reinterpret_cast<int*>(tab + table_len(a));
  const int entry = mask_entry(a, win);
  const uint32_t* mb =
      stage_bits(a, entry, reinterpret_cast<uint32_t*>(cb + NP));
  const float* src = static_cast<const float*>(a.qkv) + win * n * c3 + h * hd;
  const int al = static_cast<int>(reinterpret_cast<uintptr_t>(src)) |
                 (4 * C) | (4 * hd);
  const int w = al & 15 ? (al & 7 ? 4 : 8) : 16;
  const int segs = 4 * hd / w, we = w / 4;
  for (int e = tid; e < n * 2 * segs; e += 256) {
    const int i = e / (2 * segs), r = e - i * 2 * segs;
    const int which = r / segs, sg = r - which * segs;
    cp_async_w((which ? Vs : Ks) + i * LD + sg * we,
               src + static_cast<long long>(i) * c3 + (which + 1) * C +
                   sg * we,
               w);
  }
  const int pad = 8 * ND - hd;
  for (int e = tid; e < (64 + NP) * pad; e += 256)
    Qs[(e / pad) * LD + hd + e % pad] = 0.f;  // Qs then Ks: one run of rows
  for (int e = tid; e < (NP - n) * LD; e += 256) Vs[n * LD + e] = 0.f;
  stage_table(a, tab, h, 1);
  bias_cols(a, cb, NP);

  const int pair = warp & 3, kh = warp >> 2;
  float* px = xs + pair * XS;
  float* out = static_cast<float*>(a.out) + win * n * C + h * hd;
  const int chunks = (n + 63) / 64;
  for (int ch = part; ch < chunks; ch += parts) {
    const int q0 = 64 * ch, nq = min(64, n - q0);
    if (ch != part) __syncthreads();  // the previous chunk's q reads are done
    for (int e = tid; e < nq * segs; e += 256) {
      const int i = e / segs, sg = e - i * segs;
      cp_async_w(Qs + i * LD + sg * we,
                 src + static_cast<long long>(q0 + i) * c3 + sg * we, w);
    }
    for (int e = tid; e < (64 - nq) * LD; e += 256) Qs[nq * LD + e] = 0.f;
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    const int r0 = q0 + 16 * pair;
    if (r0 < n)
      attn_rows_tf32<NP, ND, W16>(
          Qs + 16 * pair * LD, Ks, Vs, LD, hd, n, r0, kh,
          W16 ? BiasRow{tab, 0} : bias_row(a, tab, 1, 0, h, r0 + g),
          W16 ? BiasRow{tab, 0} : bias_row(a, tab, 1, 0, h, r0 + g + 8),
          mask_row(a, entry, mb, r0 + g), mask_row(a, entry, mb, r0 + g + 8),
          cb, a.scale, a.fast, out, C, lane, px, px + 64, 1 + pair);
  }
}

// float32, N <= 64: one warp's 16 query rows r0 .. of one head over all
// the keys, as attn_rows64 in bf16 (no pair, no exchange): S = q k^T and O
// = p v in split TF32 as attn_rows_tf32 computes them, the softmax on the
// accumulators over each row's quad (xor shuffles), O's rows divided by the
// sums at the end. The head's q, k, v tiles have pitch LD (a compile-time
// constant: every fragment address is a register plus an immediate); q's
// columns past hd are zeroed in registers (a tile's columns hd .. 8 ND
// hold the next head's), so k's and v's there need only be finite.
template <int ND>
__device__ __forceinline__ void attn_rows64_tf32(
    const float* Q, const float* K, const float* V, int LD, int hd, int n,
    int r0, const BiasRow& b0, const BiasRow& b1, const MaskRow& m0,
    const MaskRow& m1, const int* cb, float scale, bool fast, float* o,
    int C, int lane) {
  const int g = lane >> 2, t = lane & 3;
  uint32_t mw[2][2] = {{0u, 0u}, {0u, 0u}};
  if (m0.w != nullptr) {
    mw[0][0] = m0.w[0];
    mw[0][1] = m0.w[1];
    mw[1][0] = m1.w[0];
    mw[1][1] = m1.w[1];
  }
  float s[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
  for (int kd = 0; kd < ND; ++kd) {
    const float* qr = Q + (r0 + g) * LD + 8 * kd + t;
    const bool c0 = 8 * kd + t < hd, c1 = 8 * kd + t + 4 < hd;
    uint32_t qh[4], ql[4];
    split_a(c0 ? qr[0] : 0.f, c0 ? qr[8 * LD] : 0.f, c1 ? qr[4] : 0.f,
            c1 ? qr[8 * LD + 4] : 0.f, qh, ql);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      if (8 * nt >= n) continue;
      const float* kr = K + (8 * nt + g) * LD + 8 * kd + t;
      mma_split(s[nt], qh, ql, kr[0], kr[4]);
    }
  }
  logit_epilogue<8, false>(s, n, 0, b0, b1, m0, m1, mw, cb, scale,
                           fast ? kLog2e : 1.f, t, BiasRow16{nullptr},
                           BiasRow16{nullptr});
  float r0v[16], r1v[16];  // rows g and g + 8 (row_softmax's form)
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    r0v[2 * nt] = s[nt][0];
    r0v[2 * nt + 1] = s[nt][1];
    r1v[2 * nt] = s[nt][2];
    r1v[2 * nt + 1] = s[nt][3];
  }
  const float l[2] = {row_softmax<16, false>(r0v, fast, 2),
                      row_softmax<16, false>(r1v, fast, 2)};
  float acc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
    acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    if (8 * nt >= n) continue;
    uint32_t ph[4], pl[4];
    split_a(r0v[2 * nt], r1v[2 * nt], r0v[2 * nt + 1], r1v[2 * nt + 1], ph,
            pl);
    const float* vr = V + (8 * nt + 2 * t) * LD + g;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
      mma_split(acc[nd], ph, pl, vr[8 * nd], vr[LD + 8 * nd]);
  }
  const float inv[2] = {1.f / l[0], 1.f / l[1]};
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = r0 + g + 8 * (e >> 1), c = 8 * nd + 2 * t + (e & 1);
      if (i < n && c < hd)
        o[i * C + c] =
            fast ? acc[nd][e] * inv[e >> 1] : acc[nd][e] / l[e >> 1];
    }
}

// float32, N <= 64, on persistent blocks that stream windows. What bounds
// this form is the bytes (the band: 3.05 GB at 3.35 TB/s, 0.91 ms, against
// 0.30 ms of split-TF32 passes), so a block stages window i + 1's q, k, v
// rows of its group of HG heads (with the window's mask bits) into one of
// two buffers while it computes window i from the other: warp w takes row
// block w % 4 of the group's head w / 4 (attn_rows64_tf32). Block b keeps
// head group b % groups for its whole walk over the windows, so the
// group's bias is staged once: the table's columns, or the dense rows where
// two blocks an SM still fit (sbias; else they are read where they lie). A
// row's three slices (q, k, v of the group: HG hd contiguous floats each)
// are copied as they lie (cp.async of 16, 8 or 4 bytes, a warp a row, its
// lanes the slices' segments) into rows of pitch HG 8 ND + 4 (4 mod 8
// words: conflict-free fragment loads); what the copies never write (rows
// past N, the columns past the slices) is zero. grid: a multiple of the
// head groups, as many blocks as fit on the card.
template <int ND, int HG>
__global__ void __launch_bounds__(256, 2)
    window_attention_tf32_stream_kernel(const Attn a, int nwin, int sbias) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int LD = HG * 8 * ND + 4, SEC = 64 * LD, BUF = 3 * SEC + 128;
  const int C = a.C, c3 = 3 * C, n = a.n, hd = C / a.heads;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, groups = a.heads / HG;
  const int h0 = static_cast<int>(blockIdx.x % groups) * HG;
  float* bufs = reinterpret_cast<float*>(smem);  // 2 x [q | k | v | bits]
  int* cb = reinterpret_cast<int*>(bufs + 2 * BUF);
  float* bias = reinterpret_cast<float*>(cb + 64);  // [HG][L] or [HG][N][N]
  const float* qkv = static_cast<const float*>(a.qkv);
  const int al = static_cast<int>(reinterpret_cast<uintptr_t>(qkv)) |
                 (4 * C) | (4 * HG * hd);
  const int w = al & 15 ? (al & 7 ? 4 : 8) : 16;
  const int segs = 4 * HG * hd / w, we = w / 4;
  const int L = table_len(a), bl = a.table != nullptr ? L : n * n;
  for (int e = tid; e < (sbias ? HG * bl : 0); e += 256) {
    const int hh = e / bl, x = e - hh * bl;
    cp_async4(bias + e, a.table != nullptr
                            ? a.table + x * a.heads + h0 + hh
                            : a.rpb + static_cast<long long>(h0 + hh) * bl +
                                  x);
  }
  bias_cols(a, cb, 64);
  for (int e = tid; e < 2 * 3 * SEC; e += 256) {
    const int r = (e / LD) % 64, c = e % LD;
    if (r >= n || c >= HG * hd)
      bufs[(e / (3 * SEC)) * BUF + e % (3 * SEC)] = 0.f;
  }
  auto stage = [&](int win, float* buf) {
    const float* src = qkv + static_cast<long long>(win) * n * c3 + h0 * hd;
    for (int i = warp; i < n; i += 8)
      for (int x = lane; x < 3 * segs; x += 32) {
        const int which = (x >= segs) + (x >= 2 * segs);
        const int sg = x - which * segs;
        cp_async_w(buf + which * SEC + i * LD + sg * we,
                   src + static_cast<long long>(i) * c3 + which * C +
                       sg * we,
                   w);
      }
    stage_bits(a, mask_entry(a, win),
               reinterpret_cast<uint32_t*>(buf + 3 * SEC));
    cp_async_commit();
  };
  const int rb = 16 * (warp & 3), hh = warp >> 2, h = h0 + hh;
  const int step = gridDim.x / groups;
  // this warp's bias rows: the head's table column (tab[L]: BiasRow's
  // table rule), or its dense rows
  const float* hb = sbias ? bias + hh * bl : a.rpb + h * bl;
  auto brow = [&](int i) {
    return a.table != nullptr ? bias_row(a, hb, 1, 0, h, i)
                              : BiasRow{hb + (i < n ? i : 0) * n, 1};
  };
  int win = blockIdx.x / groups;
  if (win < nwin) stage(win, bufs);
  for (int k = 0; win < nwin; ++k, win += step) {
    if (win + step < nwin)
      stage(win + step, bufs + ((k + 1) & 1) * BUF);
    else
      cp_async_commit();  // an empty group: the wait below stays uniform
    cp_async_wait<1>();
    __syncthreads();
    const float* buf = bufs + (k & 1) * BUF + hh * hd;
    const int entry = mask_entry(a, win);
    const uint32_t* mb =
        a.bits != nullptr && entry >= 0
            ? reinterpret_cast<const uint32_t*>(bufs + (k & 1) * BUF + 3 * SEC)
            : nullptr;
    if (rb < n && hh < HG)
      attn_rows64_tf32<ND>(
          buf, buf + SEC, buf + 2 * SEC, LD, hd, n, rb, brow(rb + g),
          brow(rb + g + 8), mask_row(a, entry, mb, rb + g),
          mask_row(a, entry, mb, rb + g + 8), cb, a.scale, a.fast,
          static_cast<float*>(a.out) + static_cast<long long>(win) * n * C +
              h * hd,
          C, lane);
    __syncthreads();  // buffer k & 1 is read: window k + 2 may stage there
  }
}

// the stream kernel's shared memory: two buffers, the bias columns, and
// the group's staged bias (sbias; L table entries or N x N dense a head)
size_t attention_tf32_stream_smem(int nd, int hg, int L, int n, int sbias) {
  const size_t ld = static_cast<size_t>(hg) * 8 * nd + 4;
  return (2 * (3 * 64 * ld + 128) + 64 +
          (sbias ? static_cast<size_t>(hg) * (L > 0 ? L : n * n) : 0)) *
         4;
}

// shared memory of one block when two share an SM (228 KB, 1 KB each
// reserved)
constexpr size_t kHalfSm = 233472 / 2 - 1024;

size_t attention_tf32_smem(int np, int nd, int L, int n, int mw) {
  const size_t ld = 8 * static_cast<size_t>(nd) + 4;
  return ((64 + 2 * static_cast<size_t>(np)) * ld +
          4 * (64 + 128 * static_cast<size_t>(nd)) + L + np +
          static_cast<size_t>(n) * mw) *
         4;
}

}  // namespace

// K2. rpb: the dense (heads, N, N) bias, or nullptr when `table` (the
// ((2ws-1)^2, heads) relative-position table, N = ws^2) is given; mask:
// nullptr or the (nmask, N, N) full mask (window w takes mask[w % nmask]);
// bank: nullptr or the (2, 2, N, N) edge bank, bit k of bank_zero set
// where bank entry k (= 2 is_last_row + is_last_col) is all zero; bits:
// nullptr, or the bit form of the bank or mask (entries x N x mw words, mw
// = Np / 32 for N padded to Np = 64, 128 or 256; bit j of a row set where
// the entry is mval, every other value 0), which the kernel then reads
// instead. N <= 256, head width <= 64 (even in bf16). scale multiplies the
// float32 q.k product before the bias is added (1 where q is pre-scaled;
// x * 1.0f is exact). parts: the float32 kernel's blocks a (window, head),
// 1 .. ceil(N / 64) (ops/swin_block.py:attention_parts; unused in bf16).
extern "C" int window_attention(const void* qkv, int dt, const void* rpb,
                                const void* table, int ws, const void* bank,
                                int bank_zero, const void* mask, int nmask,
                                const void* bits, float mval, void* out,
                                int nwin, int n, int C, int heads, int nwy,
                                int nwx, int fast, float scale,
                                int parts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || n > MAXN || heads < 1 || C % heads || C / heads > 64 ||
      (table != nullptr && ws * ws != n) || (table == nullptr && !rpb))
    return cudaErrorInvalidValue;
  const int hd = C / heads;
  const int np = n <= 64 ? 64 : n <= 128 ? 128 : 256;
  const int mw = np / 32;
  const Attn a{qkv, static_cast<const float*>(rpb),
               static_cast<const float*>(table),
               static_cast<const float*>(bank),
               static_cast<const float*>(mask),
               static_cast<const uint32_t*>(bits), out, nmask, n, C, heads,
               nwy, nwx, ws, fast, bank_zero, mw, scale, mval};
  const int L = table != nullptr ? (2 * ws - 1) * (2 * ws - 1) : 0;
  auto launch = [&](auto kernel, unsigned blocks, size_t smem,
                    auto... more) {
    if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<blocks, 256, smem, s>>>(a, more...);
    return static_cast<int>(cudaGetLastError());
  };
  const unsigned per_head = static_cast<unsigned>(nwin) * heads;
  if (dt == kBF16) {
    if (hd % 2) return cudaErrorInvalidValue;
    const int kd = hd <= 16 ? 1 : hd <= 32 ? 2 : 4;
    const size_t smem = attention_mma_smem(np, kd, C, heads, L, n, mw);
    if (table != nullptr && ws == 16) {  // HAT's window: constant offsets
      switch (kd) {
        case 1:
          return launch(window_attention_mma_kernel<256, 1, true>, per_head,
                        smem);
        case 2:
          return launch(window_attention_mma_kernel<256, 2, true>, per_head,
                        smem);
        default:
          return launch(window_attention_mma_kernel<256, 4, true>, per_head,
                        smem);
      }
    }
    switch (np * 10 + kd) {
#define IRK_CASE(NP, KD)                                                  \
  case NP * 10 + KD:                                                      \
    return launch(window_attention_mma_kernel<NP, KD>,                    \
                  NP == 64 ? static_cast<unsigned>(nwin) : per_head, smem);
      IRK_CASE(64, 1) IRK_CASE(64, 2) IRK_CASE(64, 4)
      IRK_CASE(128, 1) IRK_CASE(128, 2) IRK_CASE(128, 4)
      IRK_CASE(256, 1) IRK_CASE(256, 2) IRK_CASE(256, 4)
#undef IRK_CASE
      default:
        return cudaErrorInvalidValue;
    }
  }
  const int chunks = (n + 63) / 64;
  if (parts < 1 || parts > chunks) return cudaErrorInvalidValue;
  const int nd = hd <= 16 ? 2 : hd <= 32 ? 4 : 8;
  if (np == 64) {  // persistent blocks, as many as fit on the card
    // heads in pairs where they are even; the dense bias staged where two
    // blocks an SM still fit with it (the table always)
    const int hg = heads % 2 == 0 &&
                           attention_tf32_stream_smem(nd, 2, L, n, 0) <=
                               kHalfSm
                       ? 2
                       : 1;
    const int sbias =
        L > 0 || attention_tf32_stream_smem(nd, hg, L, n, 1) <= kHalfSm;
    const size_t smem = attention_tf32_stream_smem(nd, hg, L, n, sbias);
    auto stream_launch = [&](auto kernel) {
      if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
      cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      int dev = 0, sms = 0, per_sm = 0;
      if (e == cudaSuccess) e = cudaGetDevice(&dev);
      if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 256,
                                                          smem);
      if (e != cudaSuccess) return static_cast<int>(e);
      const int groups = heads / hg;
      const int fit = std::max(1, std::max(per_sm, 1) * sms / groups);
      const long long grid =
          static_cast<long long>(groups) * std::min(nwin, fit);
      kernel<<<static_cast<unsigned>(grid), 256, smem, s>>>(a, nwin,
                                                            sbias);
      return static_cast<int>(cudaGetLastError());
    };
    switch (nd * 10 + hg) {
      case 21:
        return stream_launch(window_attention_tf32_stream_kernel<2, 1>);
      case 22:
        return stream_launch(window_attention_tf32_stream_kernel<2, 2>);
      case 41:
        return stream_launch(window_attention_tf32_stream_kernel<4, 1>);
      case 42:
        return stream_launch(window_attention_tf32_stream_kernel<4, 2>);
      case 81:
        return stream_launch(window_attention_tf32_stream_kernel<8, 1>);
      default:
        return stream_launch(window_attention_tf32_stream_kernel<8, 2>);
    }
  }
  const size_t smem = attention_tf32_smem(np, nd, L, n, mw);
  const unsigned blocks = per_head * static_cast<unsigned>(parts);
  if (table != nullptr && ws == 16) {  // HAT's window: constant offsets
    switch (nd) {
      case 2:
        return launch(window_attention_tf32_kernel<256, 2, true>, blocks,
                      smem, parts);
      case 4:
        return launch(window_attention_tf32_kernel<256, 4, true>, blocks,
                      smem, parts);
      default:
        return launch(window_attention_tf32_kernel<256, 8, true>, blocks,
                      smem, parts);
    }
  }
  switch (np * 10 + nd) {
#define IRK_CASE(NP, ND)  \
  case NP * 10 + ND:      \
    return launch(window_attention_tf32_kernel<NP, ND>, blocks, smem, parts);
    IRK_CASE(128, 2) IRK_CASE(128, 4) IRK_CASE(128, 8)
    IRK_CASE(256, 2) IRK_CASE(256, 4) IRK_CASE(256, 8)
#undef IRK_CASE
    default:
      return cudaErrorInvalidValue;
  }
}
