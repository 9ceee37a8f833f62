// K8: a pair of Swin blocks in one launch, replacing the TPU kernel
// image_restoration_agent_tpu/ops/pallas_attention.py:swin_pair_strip_pallas
// (body _strip_kernel_pairfused). See ops/swin_block.py:swin_pair_block for
// the function: block A (unshifted, read through roll(x, dc1)) then block B
// (shifted, read through roll(A's output, -ws/2), the mask bank), the fast
// numerics of the port's swin_block, the output in frame -ws/2.
//
// Design: one thread block per output window of B; block A's output never
// reaches device memory.
//   - In the rolled frame, B's window (wy, wx) covers a quarter (ws/2 x
//     ws/2) of each of the four A windows (wy + {0,1}, wx + {0,1}), indices
//     modulo the window counts (the last row and column wrap to the first).
//   - For each of those A windows the block runs LN1 -> k, v for all N
//     tokens, and q -> attention -> proj + residual -> LN2 -> MLP ->
//     residual only for the N/4 tokens inside B's window, which it writes,
//     cast to the canvas dtype, into B's token tile in shared memory.
//   - Then it runs block B whole on that tile, the bank picked by the
//     window's last row and column in the output frame, and writes B's
//     output to the output frame.
// Recomputation: A's LN1, k and v run four times (once per B window that
// needs the A window), about 35% more FLOP than the pair's own work (at C
// 180, N 64: 9.7e7 against 7.2e7 FLOP per window).
//
// Numerics (the port's fast swin_block, kernels K1 and K2): LN in float32,
// the operand rounded to the canvas dtype; q, k, v in the canvas dtype (q
// carries the attention scale from the weights); logits (q.k + rpb (+
// bank)) * log2(e) in float32, exp2(min(l, 86.56)), a reciprocal
// normalization, p rounded before p.v; the attention output in the canvas
// dtype; proj + residual in float32 (x1), kept in float32 into the MLP
// half; tanh-GELU, the hidden activation rounded; fc2 + b2 + x1 cast once.
// fc2's products are summed over the hidden chunks into x1 in shared
// memory (another order than K1's, float32 rounding).
//
// Products: bf16 as WMMA 16x16x16 fragments with float32 accumulators, the
// weights' fragments read from L2 (the qkv weight, 221 KB at C 180, does
// not sit in shared memory beside the rest); f32 on FP32 FMA. The weights
// come head-major (ops/swin_block.py:_pair_form): per head [q | k | v]
// columns, each zero-padded to hdp (16 in bf16), proj's rows to match, so
// every head's slices are aligned fragments.
//
// What bounds it: at the SwinIR-M band (552x1920, C 180) the pair is
// 1.20e12 FLOP of its own work against 0.76 GB of input and output: the
// tensor cores (1.2 ms bf16; 17.9 ms on the FP32 pipes in f32).
//
// Plain C interface for ctypes; the entry returns cudaGetLastError().

#include <mma.h>

#include <type_traits>

#include "common.cuh"

using namespace irk;
using namespace nvcuda;

namespace {

constexpr int NT = 256;
constexpr int NWARP = NT / 32;
constexpr float LOG2E = 1.4426950408889634f;

// one block's weights (ops/swin_block.py:_pair_form order)
struct BlockW {
  const float* ln1_g;
  const float* ln1_b;
  const void* wqkv;   // (kp, heads * 3 * hdp), head-major
  const float* bqkv;  // (heads * 3 * hdp)
  const void* wproj;  // (heads * hdp, ldproj)
  const float* bproj;
  const float* rpb;   // (heads, N, N)
  const float* ln2_g;
  const float* ln2_b;
  const void* w1;     // (kp, ldw1)
  const float* b1;    // (hid)
  const void* w2;     // (hidp, ldw2)
  const float* b2;
};

struct Geo {
  int B, H, W, C, heads, hd, hdp, kp, hid, hidp, ldqkv, ldproj, ldw1, ldw2,
      cn, ws, n, np, dc1;
};

struct Lay {
  size_t xb, ao, y, yq, qkv, s, p, x1, hc, scr, src, total;
  int ldc, ldo, ldq, lds, ldp, ldx, ldh, hcw;
};

__host__ __device__ inline size_t take(size_t& o, size_t bytes) {
  const size_t at = o;
  o = (o + bytes + 127) / 128 * 128;
  return at;
}

__host__ __device__ inline size_t umax(size_t a, size_t b) {
  return a > b ? a : b;
}

// Shared memory. Three phases reuse one region: LN1 / qkv / attention
// (y, yq, qkv, s, p) and proj / MLP (x1, hc); LN2's output takes the
// attention output's place.
__host__ __device__ inline Lay layout(bool bf, const Geo& g) {
  Lay l;
  const int es = bf ? 2 : 4;
  const int pad = bf ? 8 : 4;
  l.ldc = g.kp + pad;
  l.ldo = g.heads * g.hdp + pad;
  l.ldq = 3 * g.hdp + (bf ? 8 : 1);
  l.lds = g.np + 4;
  l.ldp = g.np + 8;
  l.ldx = g.C + 4;
  l.hcw = bf ? 128 : 64;
  l.ldh = l.hcw + pad;
  size_t o = 0;
  l.src = take(o, 64 * sizeof(long long));
  l.xb = take(o, static_cast<size_t>(g.np) * l.ldc * es);
  l.ao = take(o, static_cast<size_t>(g.np) *
                     (l.ldo > l.ldc ? l.ldo : l.ldc) * es);
  l.scr = take(o, bf ? NWARP * 256 * 4 : 0);
  const size_t u = o;
  size_t a = u;
  l.y = take(a, static_cast<size_t>(g.np) * l.ldc * es);
  l.yq = take(a, 16 * static_cast<size_t>(l.ldc) * es);
  l.qkv = take(a, static_cast<size_t>(g.np) * l.ldq * es);
  l.s = take(a, static_cast<size_t>(g.np) * l.lds * 4);
  l.p = take(a, bf ? static_cast<size_t>(g.np) * l.ldp * 2 : 0);
  size_t b = u;
  l.x1 = take(b, static_cast<size_t>(g.np) * l.ldx * 4);
  l.hc = take(b, static_cast<size_t>(g.np) * l.ldh * es);
  l.total = umax(a, b);
  return l;
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float gelu_tanh(float v) {
  return 0.5f * v * (1.f + tanhf(0.7978845608f * (v + 0.044715f * v * v * v)));
}

// C[M x N] = A[M x K] . B, B (k, n) at Bm[k * ldb + n] (row-major) or
// Bm[n * ldb + k] (BCOL); epi(r, c, value) for every element, each called
// by one thread. bf16: WMMA, M, N, K multiples of 16, fragments aligned;
// f32: FP32 FMA, 4 rows a thread, M a multiple of 4. The caller syncs.
template <bool BCOL, typename Epi>
__device__ void tiles(const __nv_bfloat16* A, int lda, int M, int K,
                      const __nv_bfloat16* Bm, int ldb, int N, float* scr,
                      Epi epi) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nfs = N / 16;
  using BL = typename std::conditional<BCOL, wmma::col_major,
                                       wmma::row_major>::type;
  for (int f = warp; f < (M / 16) * nfs; f += NWARP) {
    const int mf = f / nfs, nf = f % nfs;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
    for (int k = 0; k < K; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          af;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, BL> bf;
      wmma::load_matrix_sync(af, A + mf * 16 * lda + k, lda);
      wmma::load_matrix_sync(
          bf, BCOL ? Bm + nf * 16 * ldb + k : Bm + k * ldb + nf * 16, ldb);
      wmma::mma_sync(acc, af, bf, acc);
    }
    wmma::store_matrix_sync(scr, acc, 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32)
      epi(mf * 16 + e / 16, nf * 16 + e % 16, scr[e]);
    __syncwarp();
  }
}

template <bool BCOL, typename Epi>
__device__ void tiles(const float* A, int lda, int M, int K, const float* Bm,
                      int ldb, int N, float* /*scr*/, Epi epi) {
  for (int it = threadIdx.x; it < (M / 4) * N; it += NT) {
    const int c = it % N, r0 = (it / N) * 4;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k = 0; k < K; ++k) {
      const float w = BCOL ? Bm[c * ldb + k] : Bm[static_cast<long long>(k) *
                                                      ldb + c];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] = fmaf(A[(r0 + i) * lda + k], w,
                                                acc[i]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) epi(r0 + i, c, acc[i]);
  }
}

// LayerNorm (float32 two-pass statistics, eps 1e-5) of `rows` rows, one
// warp per row, read through rd(r, k); rows past `valid` and columns past
// C up to kp are zero. The caller syncs.
template <typename T, typename Rd>
__device__ void ln_rows(int rows, int valid, int C, int kp, Rd rd,
                        const float* g, const float* bt, T* Y, int ldc) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < rows; r += NWARP) {
    T* yr = Y + r * ldc;
    if (r >= valid) {  // uniform across the warp
      for (int k = lane; k < kp; k += 32) yr[k] = from_f<T>(0.f);
      continue;
    }
    float s = 0.f;
    for (int k = lane; k < C; k += 32) s += rd(r, k);
    const float mu = warp_sum(s) / C;
    float v = 0.f;
    for (int k = lane; k < C; k += 32) {
      const float d = rd(r, k) - mu;
      v += d * d;
    }
    const float rs = rsqrtf(warp_sum(v) / C + 1e-5f);
    for (int k = lane; k < kp; k += 32)
      yr[k] = from_f<T>(k < C ? (rd(r, k) - mu) * rs * g[k] + bt[k] : 0.f);
  }
}

template <typename T>
struct Smem {
  T *xb, *ao, *y, *yq, *qkv, *p, *hc;
  float *s, *x1, *scr;
  long long* src;
  Lay L;
};

// Window attention of one block over its `mq` query rows (Yq, or Y when
// the queries are all tokens) and np key rows (Y), head by head, into AO.
// Query row i is token tq(i) of the window; rows past `valid` get p = 0.
template <typename T, typename Tq>
__device__ void attention(const Smem<T>& m, const Geo& g, const BlockW& w,
                          const T* Q, int mq, int valid, Tq tq,
                          const float* bank) {
  const Lay& L = m.L;
  const T* wqkv = static_cast<const T*>(w.wqkv);
  constexpr bool BF = std::is_same<T, __nv_bfloat16>::value;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int h = 0; h < g.heads; ++h) {
    const int c0 = h * 3 * g.hdp;
    tiles<false>(Q, L.ldc, mq, g.kp, wqkv + c0, g.ldqkv, g.hdp, m.scr,
                 [&](int r, int c, float v) {
                   m.qkv[r * L.ldq + c] = from_f<T>(v + w.bqkv[c0 + c]);
                 });
    tiles<false>(m.y, L.ldc, g.np, g.kp, wqkv + c0 + g.hdp, g.ldqkv,
                 2 * g.hdp, m.scr, [&](int r, int c, float v) {
                   m.qkv[r * L.ldq + g.hdp + c] =
                       from_f<T>(v + w.bqkv[c0 + g.hdp + c]);
                 });
    __syncthreads();
    // S = q k^T (float32)
    tiles<true>(m.qkv, L.ldq, mq, BF ? g.hdp : g.hd, m.qkv + g.hdp, L.ldq,
                g.np, m.scr,
                [&](int r, int c, float v) { m.s[r * L.lds + c] = v; });
    __syncthreads();
    const float* rb = w.rpb + static_cast<long long>(h) * g.n * g.n;
    for (int i = warp; i < mq; i += NWARP) {
      const bool row = i < valid;  // uniform across the warp
      const int t = row ? tq(i) : 0;
      float e[2];
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = lane + 32 * jj;
        e[jj] = 0.f;
        if (row && j < g.n) {
          float bias = rb[t * g.n + j];
          if (bank != nullptr) bias += bank[t * g.n + j];
          e[jj] = exp2f(fminf((m.s[i * L.lds + j] + bias) * LOG2E, 86.56f));
        }
        sum += e[jj];
      }
      sum = warp_sum(sum);
      const float inv = row ? 1.f / sum : 0.f;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = lane + 32 * jj;
        if (j >= g.np) continue;
        if constexpr (BF)
          m.p[i * L.ldp + j] = __float2bfloat16_rn(e[jj] * inv);
        else
          m.s[i * L.lds + j] = e[jj] * inv;
      }
    }
    __syncthreads();
    // O = p v into the head's columns of AO
    const T* pm;
    int ldp;
    if constexpr (BF) {
      pm = m.p;
      ldp = L.ldp;
    } else {
      pm = m.s;
      ldp = L.lds;
    }
    tiles<false>(pm, ldp, mq, g.np, m.qkv + 2 * g.hdp, L.ldq,
                 BF ? g.hdp : g.hd, m.scr, [&](int r, int c, float v) {
                   m.ao[r * L.ldo + h * g.hdp + c] = from_f<T>(v);
                 });
    __syncthreads();
  }
}

// proj + residual -> x1 (float32), LN2, then the MLP summed into x1 over
// hidden chunks. res(r, c) is the residual; rows past `valid` are dropped.
template <typename T, typename Res>
__device__ void proj_mlp(const Smem<T>& m, const Geo& g, const BlockW& w,
                         int mrows, int valid, Res res) {
  const Lay& L = m.L;
  tiles<false>(m.ao, L.ldo, mrows, g.heads * g.hdp,
               static_cast<const T*>(w.wproj), g.ldproj, g.cn, m.scr,
               [&](int r, int c, float v) {
                 if (r < valid && c < g.C)
                   m.x1[r * L.ldx + c] = v + w.bproj[c] + res(r, c);
               });
  __syncthreads();
  T* y2 = m.ao;
  ln_rows<T>(mrows, valid, g.C, g.kp,
             [&](int r, int k) { return m.x1[r * L.ldx + k]; }, w.ln2_g,
             w.ln2_b, y2, L.ldc);
  __syncthreads();
  const T* w1 = static_cast<const T*>(w.w1);
  const T* w2 = static_cast<const T*>(w.w2);
  for (int h0 = 0; h0 < g.hidp; h0 += L.hcw) {
    const int nh = min(L.hcw, g.hidp - h0);
    tiles<false>(y2, L.ldc, mrows, g.kp, w1 + h0, g.ldw1, nh, m.scr,
                 [&](int r, int c, float v) {
                   const float b = h0 + c < g.hid ? w.b1[h0 + c] : 0.f;
                   m.hc[r * L.ldh + c] = from_f<T>(gelu_tanh(v + b));
                 });
    __syncthreads();
    tiles<false>(m.hc, L.ldh, mrows, nh,
                 w2 + static_cast<long long>(h0) * g.ldw2, g.ldw2, g.cn,
                 m.scr, [&](int r, int c, float v) {
                   if (r < valid && c < g.C) m.x1[r * L.ldx + c] += v;
                 });
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) swin_pair_kernel(
    const T* __restrict__ x, T* __restrict__ out, BlockW wa, BlockW wb,
    const float* __restrict__ bank, Geo g) {
  constexpr bool BF = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(128) unsigned char smem[];
  Smem<T> m;
  m.L = layout(BF, g);
  const Lay& L = m.L;
  m.src = reinterpret_cast<long long*>(smem + L.src);
  m.xb = reinterpret_cast<T*>(smem + L.xb);
  m.ao = reinterpret_cast<T*>(smem + L.ao);
  m.y = reinterpret_cast<T*>(smem + L.y);
  m.yq = reinterpret_cast<T*>(smem + L.yq);
  m.qkv = reinterpret_cast<T*>(smem + L.qkv);
  m.s = reinterpret_cast<float*>(smem + L.s);
  m.p = reinterpret_cast<T*>(smem + L.p);
  m.x1 = reinterpret_cast<float*>(smem + L.x1);
  m.hc = reinterpret_cast<T*>(smem + L.hc);
  m.scr = reinterpret_cast<float*>(smem + L.scr) + (threadIdx.x / 32) * 256;

  const int tid = threadIdx.x;
  const int ws = g.ws, s = ws / 2, n = g.n, nq = s * s;
  const int nwx = g.W / ws, nwy = g.H / ws;
  long long bid = blockIdx.x;
  const int wx = static_cast<int>(bid % nwx);
  bid /= nwx;
  const int wy = static_cast<int>(bid % nwy);
  const long long b = bid / nwy;

  // block A on the four windows whose quarters make B's window
  for (int q = 0; q < 4; ++q) {
    const int qy = q / 2, qx = q % 2;
    const int ay = (wy + qy) % nwy, ax = (wx + qx) % nwx;
    // A's token t reads x[(i - dc1) mod H, (j - dc1) mod W]
    for (int t = tid; t < n; t += NT) {
      const int i = ay * ws + t / ws, j = ax * ws + t % ws;
      m.src[t] = (b * g.H + pmod(i - g.dc1, g.H)) * g.W + pmod(j - g.dc1,
                                                               g.W);
    }
    __syncthreads();
    ln_rows<T>(g.np, n, g.C, g.kp,
               [&](int r, int k) { return to_f(x[m.src[r] * g.C + k]); },
               wa.ln1_g, wa.ln1_b, m.y, L.ldc);
    __syncthreads();
    // the quarter of A's window inside B's window: local rows and columns
    // (1 - qy) * s.. and (1 - qx) * s..
    auto tq = [&](int r) {
      return ((1 - qy) * s + r / s) * ws + (1 - qx) * s + r % s;
    };
    for (int e = tid; e < 16 * g.kp; e += NT) {
      const int r = e / g.kp, k = e % g.kp;
      m.yq[r * L.ldc + k] = r < nq ? m.y[tq(r) * L.ldc + k] : from_f<T>(0.f);
    }
    __syncthreads();
    attention(m, g, wa, m.yq, 16, nq, tq, nullptr);
    proj_mlp(m, g, wa, 16, nq, [&](int r, int c) {
      return to_f(x[m.src[tq(r)] * g.C + c]);
    });
    // A's output, cast to the canvas dtype, at its place in B's window
    for (int e = tid; e < nq * g.C; e += NT) {
      const int r = e / g.C, c = e % g.C;
      const int bt = (qy * s + r / s) * ws + qx * s + r % s;
      m.xb[bt * L.ldc + c] = from_f<T>(m.x1[r * L.ldx + c] + wa.b2[c]);
    }
    __syncthreads();
  }

  // block B on its window, the bank by the window's place in the output
  // frame
  const float* bk =
      bank == nullptr
          ? nullptr
          : bank + ((wy == nwy - 1) * 2 + (wx == nwx - 1)) *
                       static_cast<long long>(n) * n;
  ln_rows<T>(g.np, n, g.C, g.kp,
             [&](int r, int k) { return to_f(m.xb[r * L.ldc + k]); },
             wb.ln1_g, wb.ln1_b, m.y, L.ldc);
  __syncthreads();
  attention(m, g, wb, m.y, g.np, n, [](int r) { return r; }, bk);
  proj_mlp(m, g, wb, g.np, n,
           [&](int r, int c) { return to_f(m.xb[r * L.ldc + c]); });
  for (int e = tid; e < n * g.C; e += NT) {
    const int r = e / g.C, c = e % g.C;
    const long long o =
        (b * g.H + wy * ws + r / ws) * g.W + wx * ws + r % ws;
    out[o * g.C + c] = from_f<T>(m.x1[r * L.ldx + c] + wb.b2[c]);
  }
}

BlockW block_w(const void* const* p) {
  BlockW w;
  w.ln1_g = static_cast<const float*>(p[0]);
  w.ln1_b = static_cast<const float*>(p[1]);
  w.wqkv = p[2];
  w.bqkv = static_cast<const float*>(p[3]);
  w.wproj = p[4];
  w.bproj = static_cast<const float*>(p[5]);
  w.rpb = static_cast<const float*>(p[6]);
  w.ln2_g = static_cast<const float*>(p[7]);
  w.ln2_b = static_cast<const float*>(p[8]);
  w.w1 = p[9];
  w.b1 = static_cast<const float*>(p[10]);
  w.w2 = p[11];
  w.b2 = static_cast<const float*>(p[12]);
  return w;
}

}  // namespace

// pa, pb: 13 device pointers each (ops/swin_block.py:_pair_form). bank:
// nullptr or the (2, 2, N, N) float32 edge bank. N = ws^2 <= 64, ws even,
// an even window count per row (the wrapper checks); the shared memory a
// block needs must fit the card's 227 KB.
extern "C" int swin_pair(const void* x, void* out, int bf16,
                         const void* const* pa, const void* const* pb,
                         const void* bank, int B, int H, int W, int C,
                         int heads, int hdp, int kp, int hid, int hidp,
                         int ldqkv, int ldproj, int ldw1, int ldw2, int cn,
                         int ws, int dc1, void* stream) {
  Geo g{B, H, W, C, heads, C / heads, hdp, kp, hid, hidp, ldqkv, ldproj,
        ldw1, ldw2, cn, ws, ws * ws, (ws * ws + 15) / 16 * 16, dc1};
  if (g.n > 64 || ws % 2 || C % heads) return cudaErrorInvalidValue;
  const size_t smem = layout(bf16 != 0, g).total;
  if (smem > 232448) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>(
      static_cast<long long>(B) * (H / ws) * (W / ws));
  const float* bk = static_cast<const float*>(bank);
  const BlockW wa = block_w(pa), wb = block_w(pb);
  auto launch = [&](auto kernel, const auto* xp, auto* op) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<blocks, NT, smem, s>>>(xp, op, wa, wb, bk, g);
    return static_cast<int>(cudaGetLastError());
  };
  if (bf16)
    return launch(swin_pair_kernel<__nv_bfloat16>,
                  static_cast<const __nv_bfloat16*>(x),
                  static_cast<__nv_bfloat16*>(out));
  return launch(swin_pair_kernel<float>, static_cast<const float*>(x),
                static_cast<float*>(out));
}
