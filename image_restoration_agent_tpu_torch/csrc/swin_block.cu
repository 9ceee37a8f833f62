// The Swin block's two kernels (replacing the TPU strip kernel
// image_restoration_agent_tpu/ops/pallas_attention.py:swin_strip_pallas,
// mlp_block_pallas, wmsa_block_pallas and, K2 alone, wmsa_pallas). See
// ops/swin_block.py for the blocks they make, what bounds them on the
// H100, and what is left for later work.
//
// K1 token_linear: out[o(t), :] = epi(pro(A[g(t), :]) @ W + bias)
//   - float32: one 64x64 output tile per block, K staged 32 at a time in
//     shared memory, 4x4 outputs per thread with FP32 FMA; bfloat16: a
//     block stages its 64 rows once and loops over every 64-column tile,
//     WMMA 16x16x16 fragments on the tensor cores, float32 accumulators;
//   - prologue: optional LayerNorm of each row (float32 two-pass
//     statistics, eps 1e-5), the operand rounded to the weight dtype;
//     optional gather g of window-order token t from the rolled canvas;
//   - epilogue: bias, optional erf/tanh GELU, optional residual read
//     through its own row map, store through map o (scatter to the output
//     frame) in float32 or bfloat16.
// K2 window_attention: q, k, v, the logits and p in shared memory (N =
//   ws^2 <= 256, head width <= 64), the mask an edge bank or a full
//   (nW, N, N) mask; float32: one block per (window, head) at N <= 64,
//   per (window, head, 64-query chunk) above, FP32 FMA; bfloat16: at
//   N <= 64 one block per window, heads in turn, at 64 < N <= 256 one
//   block per (window, head, 64-query chunk), QK^T and PV as WMMA
//   fragments. The logits are (q.k) * scale + bias: scale 1 for the Swin
//   block's callers (q pre-scaled in the weights), head_dim**-0.5 for the
//   TPU's wmsa_pallas contract (q unscaled, the product scaled in float32;
//   ops/swin_block.py:wmsa).
//
// Plain C interface for ctypes; each entry returns cudaGetLastError().

#include <mma.h>

#include "common.cuh"

using namespace irk;
using namespace nvcuda;

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int NT = 256;

struct Geom {
  int B, H, W, ws, dc;
};

// Row of token t under a row map (the same arithmetic as
// ops/swin_block.py:_row_map). Token order is window order: window
// (b, wy, wx) row-major, then (iy, ix) inside the window.
//   0: identity; 1: source pixel of the rolled canvas, x[(i-dc) mod H,
//   (j-dc) mod W]; 2: pixel (i, j) of the output frame.
__device__ __forceinline__ long long map_row(long long t, int mode,
                                             const Geom& g) {
  if (mode == 0) return t;
  const int n = g.ws * g.ws;
  const long long win = t / n;
  const int r = static_cast<int>(t - win * n);
  const int iy = r / g.ws, ix = r - iy * g.ws;
  const int nwx = g.W / g.ws, nwy = g.H / g.ws;
  const int wx = static_cast<int>(win % nwx);
  const long long rest = win / nwx;
  const int wy = static_cast<int>(rest % nwy);
  const long long b = rest / nwy;
  int i = wy * g.ws + iy, j = wx * g.ws + ix;
  if (mode == 1) {
    i = pmod(i - g.dc, g.H);
    j = pmod(j - g.dc, g.W);
  }
  return (b * g.H + i) * g.W + j;
}

// LayerNorm statistics of the block's BM rows (float32, two passes, eps
// 1e-5), one warp per row; rows with srow < 0 are past the end.
__device__ __forceinline__ void row_stats(const void* __restrict__ A,
                                          int a_dt, const long long* srow,
                                          int K, float* mean_s,
                                          float* rstd_s) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < BM; r += NT / 32) {
    const long long row = srow[r];
    float mu = 0.f, rs = 0.f;
    if (row >= 0) {  // uniform across the warp
      float s = 0.f;
      for (int k = lane; k < K; k += 32) s += load_any(A, row * K + k, a_dt);
      mu = warp_sum(s) / K;
      float v = 0.f;
      for (int k = lane; k < K; k += 32) {
        const float d = load_any(A, row * K + k, a_dt) - mu;
        v += d * d;
      }
      rs = rsqrtf(warp_sum(v) / K + 1e-5f);
    }
    if (lane == 0) {
      mean_s[r] = mu;
      rstd_s[r] = rs;
    }
  }
}

// float32: FP32 FMA, 4x4 outputs per thread
__global__ void __launch_bounds__(NT) token_linear_kernel(
    const void* __restrict__ A, int a_dt, const float* __restrict__ Wt,
    const float* __restrict__ bias, const void* __restrict__ R, int r_dt,
    void* __restrict__ O, int o_dt, const float* __restrict__ ln_g,
    const float* __restrict__ ln_b, long long M, int K, int N, int gelu,
    Geom g, int a_map, int r_map, int o_map) {
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN];
  __shared__ long long srow[BM];
  __shared__ float mean_s[BM];
  __shared__ float rstd_s[BM];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int n_tiles = (N + BN - 1) / BN;
  const long long m0 = static_cast<long long>(blockIdx.x / n_tiles) * BM;
  const int n0 = static_cast<int>(blockIdx.x % n_tiles) * BN;

  for (int r = tid; r < BM; r += NT) {
    const long long t = m0 + r;
    srow[r] = t < M ? map_row(t, a_map, g) : -1;
  }
  __syncthreads();

  if (ln_g != nullptr) {
    row_stats(A, a_dt, srow, K, mean_s, rstd_s);
    __syncthreads();
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = tid; e < BM * BK; e += NT) {
      const int r = e / BK, k = e % BK;
      const long long row = srow[r];
      float v = 0.f;
      if (row >= 0 && k0 + k < K) {
        v = load_any(A, row * K + k0 + k, a_dt);
        if (ln_g != nullptr)
          v = (v - mean_s[r]) * rstd_s[r] * ln_g[k0 + k] + ln_b[k0 + k];
      }
      As[k][r] = v;
    }
    for (int e = tid; e < BK * BN; e += NT) {
      const int k = e / BN, c = e % BN;
      float v = 0.f;
      if (k0 + k < K && n0 + c < N)
        v = Wt[static_cast<long long>(k0 + k) * N + n0 + c];
      Bs[k][c] = v;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long t = m0 + ty * 4 + i;
    if (t >= M) continue;
    const long long orow = map_row(t, o_map, g);
    const long long rrow = R != nullptr ? map_row(t, r_map, g) : 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx * 4 + j;
      if (c >= N) continue;
      float v = acc[i][j] + bias[c];
      if (gelu == 1) {
        v = 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
      } else if (gelu == 2) {
        v = 0.5f * v *
            (1.f + tanhf(0.7978845608f * (v + 0.044715f * v * v * v)));
      }
      if (R != nullptr) v += load_any(R, rrow * N + c, r_dt);
      store_any(O, orow * N + c, o_dt, v);
    }
  }
}

// bf16: the products on the tensor cores (WMMA 16x16x16 bf16 fragments,
// float32 accumulators). A block owns 64 rows and loops over every 64-column
// tile of the output:
//   - the rows are read once, a warp per row held in registers (K % 4 == 0,
//     K <= MAXK), normalized and written to shared memory as a bf16 panel
//     that serves every column tile;
//   - the weight, zero-padded once (kernel_matrix) to (Kpad, ldw) with Kpad
//     a multiple of 32 and ldw of 64, streams through two shared-memory
//     buffers of BK rows with 16-byte cp.async copies (one per thread),
//     the next chunk in flight while the current one multiplies;
//   - 8 warps tile each 64x64 output 4 (rows) x 2 (32 columns); the
//     accumulators go through shared memory so the epilogue stores rows.
constexpr int MAXK = 512;
constexpr int BLD = BN + 8;  // bf16 pitch: 16-byte rows, aligned fragments
constexpr int CLD = BN + 4;  // float pitch of the accumulator tile

// 4 consecutive elements of a float32 or bfloat16 row (8/16-byte aligned)
__device__ __forceinline__ float4 load4(const void* p, long long i, int dt) {
  if (dt == kBF16) {
    const uint2 raw =
        *reinterpret_cast<const uint2*>(static_cast<const __nv_bfloat16*>(p) +
                                        i);
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
  return *reinterpret_cast<const float4*>(static_cast<const float*>(p) + i);
}

__global__ void __launch_bounds__(NT) token_linear_mma_kernel(
    const void* __restrict__ A, int a_dt,
    const __nv_bfloat16* __restrict__ Wp, int ldw,
    const float* __restrict__ bias, const void* __restrict__ R, int r_dt,
    void* __restrict__ O, int o_dt, const float* __restrict__ ln_g,
    const float* __restrict__ ln_b, long long M, int K, int N, int gelu,
    Geom g, int a_map, int r_map, int o_map) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int kpad = (K + BK - 1) / BK * BK;
  const int kp = kpad + 8;  // panel pitch
  __nv_bfloat16* Ap = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = Ap + BM * kp;                  // [2][BK][BLD]
  float* Cs = reinterpret_cast<float*>(Bs + 2 * BK * BLD);
  long long* orow = reinterpret_cast<long long*>(Cs + BM * CLD);
  long long* rrow = orow + BM;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  for (int r = tid; r < BM; r += NT) {
    const long long t = m0 + r;
    const bool in = t < M;
    orow[r] = in ? map_row(t, o_map, g) : -1;
    rrow[r] = in && R != nullptr ? map_row(t, r_map, g) : -1;
  }

  // the A panel: one warp per row, the row in registers (K/4 float4s)
  const int k4 = K / 4;
  for (int r = warp; r < BM; r += NT / 32) {
    const long long t = m0 + r;
    const long long row = t < M ? map_row(t, a_map, g) : -1;
    float4 v[MAXK / 128];
#pragma unroll
    for (int j = 0; j < MAXK / 128; ++j) {
      const int c = lane + 32 * j;
      v[j] = (row >= 0 && c < k4) ? load4(A, row * K + 4 * c, a_dt)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    float mu = 0.f, rs = 1.f;
    if (ln_g != nullptr && row >= 0) {  // uniform across the warp
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < MAXK / 128; ++j) s += v[j].x + v[j].y + v[j].z + v[j].w;
      mu = warp_sum(s) / K;
      float q = 0.f;
#pragma unroll
      for (int j = 0; j < MAXK / 128; ++j) {
        if (lane + 32 * j >= k4) continue;
        const float a = v[j].x - mu, b = v[j].y - mu, c = v[j].z - mu,
                    d = v[j].w - mu;
        q += a * a + b * b + c * c + d * d;
      }
      rs = rsqrtf(warp_sum(q) / K + 1e-5f);
    }
#pragma unroll
    for (int j = 0; j < MAXK / 128; ++j) {
      const int c = lane + 32 * j;
      if (c >= k4) continue;
      float e[4] = {v[j].x, v[j].y, v[j].z, v[j].w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (row < 0) {
          e[q] = 0.f;
        } else if (ln_g != nullptr) {
          e[q] = (e[q] - mu) * rs * ln_g[4 * c + q] + ln_b[4 * c + q];
        }
      }
      __nv_bfloat162 lo = __floats2bfloat162_rn(e[0], e[1]);
      __nv_bfloat162 hi = __floats2bfloat162_rn(e[2], e[3]);
      uint2 packed;
      packed.x = *reinterpret_cast<unsigned*>(&lo);
      packed.y = *reinterpret_cast<unsigned*>(&hi);
      *reinterpret_cast<uint2*>(Ap + r * kp + 4 * c) = packed;
    }
    for (int k = K + lane; k < kpad; k += 32)
      Ap[r * kp + k] = __float2bfloat16_rn(0.f);
  }

  const int ksteps = kpad / BK, ntiles = (N + BN - 1) / BN;
  const int total = ksteps * ntiles;
  // one 16-byte copy per thread: BK rows x 8 chunks of 8 bf16
  const int bk_row = tid / 8, bk_ch = tid % 8;
  auto load_b = [&](int st) {
    const int nt = st / ksteps, ks = st % ksteps;
    cp_async16(Bs + ((st & 1) * BK + bk_row) * BLD + bk_ch * 8,
               Wp + static_cast<long long>(ks * BK + bk_row) * ldw +
                   nt * BN + bk_ch * 8);
    cp_async_commit();
  };

  const int wm = warp % 4, wn = warp / 4;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);
  load_b(0);
  for (int st = 0; st < total; ++st) {
    if (st + 1 < total) {
      load_b(st + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // chunk st (and, at st 0, the panel) visible
    const int ks = st % ksteps;
    const __nv_bfloat16* bt = Bs + (st & 1) * BK * BLD;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          af;
      wmma::load_matrix_sync(af, Ap + wm * 16 * kp + ks * BK + kk, kp);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major>
            bf;
        wmma::load_matrix_sync(bf, bt + kk * BLD + wn * 32 + j * 16, BLD);
        wmma::mma_sync(acc[j], af, bf, acc[j]);
      }
    }
    if (ks == ksteps - 1) {  // the column tile is complete: epilogue
      const int n0 = (st / ksteps) * BN;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::store_matrix_sync(Cs + wm * 16 * CLD + wn * 32 + j * 16,
                                acc[j], CLD, wmma::mem_row_major);
        wmma::fill_fragment(acc[j], 0.f);
      }
      __syncthreads();
      for (int e = tid; e < BM * BN; e += NT) {
        const int r = e / BN, cc = e % BN;
        const int c = n0 + cc;
        const long long o = orow[r];
        if (o < 0 || c >= N) continue;
        float v = Cs[r * CLD + cc] + bias[c];
        if (gelu == 1) {
          v = 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
        } else if (gelu == 2) {
          v = 0.5f * v *
              (1.f + tanhf(0.7978845608f * (v + 0.044715f * v * v * v)));
        }
        if (R != nullptr) v += load_any(R, rrow[r] * N + c, r_dt);
        store_any(O, o * N + c, o_dt, v);
      }
    }
    __syncthreads();  // buffers (and Cs) free for the next step
  }
}

size_t mma_smem_bytes(int K) {
  const int kpad = (K + BK - 1) / BK * BK;
  return static_cast<size_t>(BM) * (kpad + 8) * 2 + 2 * BK * BLD * 2 +
         BM * CLD * 4 + 2 * BM * sizeof(long long);
}

constexpr int QCF = 64;     // float32: query rows per block
constexpr int MAXN = 256;   // tokens per window
constexpr int MAXJ = MAXN / 32;

// The additive mask of window `win`, or nullptr:
//   - full-mask mode (the TPU's wmsa kernels): mask[win % nmask];
//   - bank mode (the strip kernel): bank[is_last_window_row,
//     is_last_window_col] by the window's place in the output frame.
__device__ __forceinline__ const float* window_mask(
    const float* bank, const float* mask, int nmask, long long win, int n,
    int nwy, int nwx) {
  const long long nn = static_cast<long long>(n) * n;
  if (mask != nullptr) return mask + (win % nmask) * nn;
  if (bank == nullptr) return nullptr;
  const int wx = static_cast<int>(win % nwx);
  const int wy = static_cast<int>((win / nwx) % nwy);
  return bank + ((wy == nwy - 1) * 2 + (wx == nwx - 1)) * nn;
}

// Softmax of one row held by a warp: v[j] is column lane + 32 j, -inf past
// the row's end. Fast: base-2 logits, clamp instead of max subtraction,
// reciprocal normalization; exact: max-subtracted, divided.
__device__ __forceinline__ void row_softmax(float (&v)[MAXJ], bool fast) {
  float s = 0.f;
  if (fast) {
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) {
      v[j] = exp2f(fminf(v[j], 86.56f));
      s += v[j];
    }
    const float inv = 1.f / warp_sum(s);
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) v[j] *= inv;
  } else {
    float m = v[0];
#pragma unroll
    for (int j = 1; j < MAXJ; ++j) m = fmaxf(m, v[j]);
    m = warp_max(m);
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) {
      v[j] = expf(v[j] - m);
      s += v[j];
    }
    const float sum = warp_sum(s);
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) v[j] /= sum;
  }
}

constexpr int AT = 128;

// float32, N <= 64: one block per (window, head), FP32 FMA; q, k, v, the
// logits and p in shared memory
__global__ void __launch_bounds__(AT) window_attention_kernel(
    const float* __restrict__ qkv, const float* __restrict__ rpb,
    const float* __restrict__ bank, const float* __restrict__ mask,
    int nmask, float* __restrict__ out, int n, int C, int heads, int nwy,
    int nwx, int fast, float scale) {
  extern __shared__ float sm[];
  const int hd = C / heads;
  const int ld = hd + 1, lds = n + 1;
  float* Q = sm;
  float* Kt = Q + n * ld;
  float* V = Kt + n * ld;
  float* S = V + n * ld;

  const long long win = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const long long base = win * n;
  const int c3 = 3 * C;

  for (int e = tid; e < n * hd; e += AT) {
    const int i = e / hd, d = e % hd;
    const float* row = qkv + (base + i) * c3 + h * hd + d;
    Q[i * ld + d] = row[0];
    Kt[i * ld + d] = row[C];
    V[i * ld + d] = row[2 * C];
  }
  __syncthreads();

  const float* bk = window_mask(bank, mask, nmask, win, n, nwy, nwx);
  const float* rb = rpb + static_cast<long long>(h) * n * n;
  const float lscale = fast ? 1.4426950408889634f : 1.f;
  for (int e = tid; e < n * n; e += AT) {
    const int i = e / n, j = e % n;
    float s = 0.f;
    for (int d = 0; d < hd; ++d) s = fmaf(Q[i * ld + d], Kt[j * ld + d], s);
    float bias = rb[i * n + j];
    if (bk != nullptr) bias += bk[i * n + j];
    S[i * lds + j] = (s * scale + bias) * lscale;
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  for (int i = warp; i < n; i += AT / 32) {
    const bool in0 = lane < n, in1 = lane + 32 < n;
    const float v0 = in0 ? S[i * lds + lane] : -INFINITY;
    const float v1 = in1 ? S[i * lds + lane + 32] : -INFINITY;
    float e0, e1;
    if (fast) {  // base-2 logits, clamp instead of max subtraction
      e0 = in0 ? exp2f(fminf(v0, 86.56f)) : 0.f;
      e1 = in1 ? exp2f(fminf(v1, 86.56f)) : 0.f;
      const float inv = 1.f / warp_sum(e0 + e1);
      e0 *= inv;
      e1 *= inv;
    } else {
      const float m = warp_max(fmaxf(v0, v1));
      e0 = in0 ? expf(v0 - m) : 0.f;
      e1 = in1 ? expf(v1 - m) : 0.f;
      const float sum = warp_sum(e0 + e1);
      e0 /= sum;
      e1 /= sum;
    }
    if (in0) S[i * lds + lane] = e0;
    if (in1) S[i * lds + lane + 32] = e1;
  }
  __syncthreads();

  for (int e = tid; e < n * hd; e += AT) {
    const int i = e / hd, d = e % hd;
    float o = 0.f;
    for (int j = 0; j < n; ++j) o = fmaf(S[i * lds + j], V[j * ld + d], o);
    out[(base + i) * C + h * hd + d] = o;
  }
}

// float32, 64 < N <= 256: one block per (window, head, 64-query chunk),
// FP32 FMA; the chunk's q, the window's k and v and the chunk's logits in
// shared memory (137 KB at N 256, head width 30: one block an SM, so it
// takes 256 threads)
constexpr int CAT = 256;

__global__ void __launch_bounds__(CAT) window_attention_chunk_kernel(
    const float* __restrict__ qkv, const float* __restrict__ rpb,
    const float* __restrict__ bank, const float* __restrict__ mask,
    int nmask, float* __restrict__ out, int n, int C, int heads, int nwy,
    int nwx, int fast, float scale) {
  extern __shared__ float sm[];
  const int hd = C / heads;
  const int ld = hd + 1, lds = n + 1;
  const int q0 = blockIdx.z * QCF;
  const int nq = min(QCF, n - q0);
  float* Q = sm;
  float* Kt = Q + min(n, QCF) * ld;
  float* V = Kt + n * ld;
  float* S = V + n * ld;

  const long long win = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const long long base = win * n;
  const int c3 = 3 * C;

  for (int e = tid; e < n * hd; e += CAT) {
    const int i = e / hd, d = e % hd;
    const float* row = qkv + (base + i) * c3 + h * hd + d;
    if (i >= q0 && i < q0 + nq) Q[(i - q0) * ld + d] = row[0];
    Kt[i * ld + d] = row[C];
    V[i * ld + d] = row[2 * C];
  }
  __syncthreads();

  const float* bk = window_mask(bank, mask, nmask, win, n, nwy, nwx);
  const float* rb = rpb + static_cast<long long>(h) * n * n;
  const float lscale = fast ? 1.4426950408889634f : 1.f;
  for (int e = tid; e < nq * n; e += CAT) {
    const int i = e / n, j = e % n;
    float s = 0.f;
    for (int d = 0; d < hd; ++d) s = fmaf(Q[i * ld + d], Kt[j * ld + d], s);
    float bias = rb[(q0 + i) * n + j];
    if (bk != nullptr) bias += bk[(q0 + i) * n + j];
    S[i * lds + j] = (s * scale + bias) * lscale;
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  for (int i = warp; i < nq; i += CAT / 32) {
    float v[MAXJ];
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) {
      const int c = lane + 32 * j;
      v[j] = c < n ? S[i * lds + c] : -INFINITY;
    }
    row_softmax(v, fast);
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) {
      const int c = lane + 32 * j;
      if (c < n) S[i * lds + c] = v[j];
    }
  }
  __syncthreads();

  for (int e = tid; e < nq * hd; e += CAT) {
    const int i = e / hd, d = e % hd;
    float o = 0.f;
    for (int j = 0; j < n; ++j) o = fmaf(S[i * lds + j], V[j * ld + d], o);
    out[(base + q0 + i) * C + h * hd + d] = o;
  }
}

// bf16: one block per window, every head in turn, on the tensor cores.
// The head's q, k, v are copied into zero-padded (64 x hdp) tiles (hdp =
// head width rounded up to 16; rows past N are zero), S = q k^T and
// O = p v run as WMMA bf16 fragments with float32 accumulators, and the
// softmax runs in float32 between them, one warp per row, exactly as in
// the float32 kernel (p is rounded to bf16 before AV, as there).
constexpr int WAT = 256;
constexpr int WN = 64;  // padded window length

__global__ void __launch_bounds__(WAT) window_attention_mma_kernel(
    const __nv_bfloat16* __restrict__ qkv, const float* __restrict__ rpb,
    const float* __restrict__ bank, const float* __restrict__ mask,
    int nmask, __nv_bfloat16* __restrict__ out, int n, int C, int heads,
    int nwy, int nwx, int fast, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int hd = C / heads;
  const int hdp = (hd + 15) / 16 * 16;
  const int qld = hdp + 8;       // bf16 pitch of q, k, v
  const int sld = WN + 4;        // float pitch of S and O
  const int pld = WN + 8;        // bf16 pitch of p
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + WN * qld;
  __nv_bfloat16* Vs = Ks + WN * qld;
  float* Ss = reinterpret_cast<float*>(Vs + WN * qld);  // S, then O
  __nv_bfloat16* Ps = reinterpret_cast<__nv_bfloat16*>(Ss + WN * sld);

  const long long win = blockIdx.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long base = win * n;
  const int c3 = 3 * C;
  const float* bk = window_mask(bank, mask, nmask, win, n, nwy, nwx);
  const float lscale = fast ? 1.4426950408889634f : 1.f;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);

  for (int h = 0; h < heads; ++h) {
    for (int e = tid; e < WN * hdp; e += WAT) {
      const int i = e / hdp, d = e % hdp;
      __nv_bfloat16 q = zero, k = zero, v = zero;
      if (i < n && d < hd) {
        const __nv_bfloat16* row = qkv + (base + i) * c3 + h * hd + d;
        q = row[0];
        k = row[C];
        v = row[2 * C];
      }
      Qs[i * qld + d] = q;
      Ks[i * qld + d] = k;
      Vs[i * qld + d] = v;
    }
    __syncthreads();

    // S = q k^T: 4 x 4 fragments of 16 x 16, two per warp
    for (int f = warp; f < 16; f += WAT / 32) {
      const int fi = f / 4, fj = f % 4;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < hdp; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major>
            af;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major>
            bf;
        wmma::load_matrix_sync(af, Qs + fi * 16 * qld + kk, qld);
        wmma::load_matrix_sync(bf, Ks + fj * 16 * qld + kk, qld);
        wmma::mma_sync(acc, af, bf, acc);
      }
      wmma::store_matrix_sync(Ss + fi * 16 * sld + fj * 16, acc, sld,
                              wmma::mem_row_major);
    }
    __syncthreads();

    const float* rb = rpb + static_cast<long long>(h) * n * n;
    for (int i = warp; i < WN; i += WAT / 32) {
      float e0 = 0.f, e1 = 0.f;
      if (i < n) {
        const bool in0 = lane < n, in1 = lane + 32 < n;
        float v0 = -INFINITY, v1 = -INFINITY;
        if (in0) {
          const float b = rb[i * n + lane] +
                          (bk != nullptr ? bk[i * n + lane] : 0.f);
          v0 = (Ss[i * sld + lane] * scale + b) * lscale;
        }
        if (in1) {
          const float b = rb[i * n + lane + 32] +
                          (bk != nullptr ? bk[i * n + lane + 32] : 0.f);
          v1 = (Ss[i * sld + lane + 32] * scale + b) * lscale;
        }
        if (fast) {
          e0 = in0 ? exp2f(fminf(v0, 86.56f)) : 0.f;
          e1 = in1 ? exp2f(fminf(v1, 86.56f)) : 0.f;
          const float inv = 1.f / warp_sum(e0 + e1);
          e0 *= inv;
          e1 *= inv;
        } else {
          const float m = warp_max(fmaxf(v0, v1));
          e0 = in0 ? expf(v0 - m) : 0.f;
          e1 = in1 ? expf(v1 - m) : 0.f;
          const float sum = warp_sum(e0 + e1);
          e0 /= sum;
          e1 /= sum;
        }
      }
      Ps[i * pld + lane] = __float2bfloat16_rn(e0);
      Ps[i * pld + lane + 32] = __float2bfloat16_rn(e1);
    }
    __syncthreads();

    // O = p v: 4 x (hdp / 16) fragments
    const int nfo = 4 * (hdp / 16);
    for (int f = warp; f < nfo; f += WAT / 32) {
      const int fi = f % 4, fj = f / 4;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < WN; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major>
            af;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major>
            bf;
        wmma::load_matrix_sync(af, Ps + fi * 16 * pld + kk, pld);
        wmma::load_matrix_sync(bf, Vs + kk * qld + fj * 16, qld);
        wmma::mma_sync(acc, af, bf, acc);
      }
      wmma::store_matrix_sync(Ss + fi * 16 * sld + fj * 16, acc, sld,
                              wmma::mem_row_major);
    }
    __syncthreads();
    for (int e = tid; e < n * hd; e += WAT) {
      const int i = e / hd, d = e % hd;
      out[(base + i) * C + h * hd + d] = __float2bfloat16_rn(Ss[i * sld + d]);
    }
    __syncthreads();  // q, k, v, S, p free for the next head
  }
}

size_t attention_mma_smem(int C, int heads) {
  const int hdp = (C / heads + 15) / 16 * 16;
  return static_cast<size_t>(3 * WN * (hdp + 8)) * 2 +
         static_cast<size_t>(WN * (WN + 4)) * 4 +
         static_cast<size_t>(WN * (WN + 8)) * 2;
}

// bf16, 64 < N <= 256 (HAT's window 16: N 256, head width 30 padded to
// 32). One (window, head)'s float32 logits at N 256 are 256 KB, more than
// a block's 227 KB, so a block takes one (window, head, 64-query chunk):
//   - shared memory: the chunk's q (64 x hdp), the window's k and v
//     (Np x hdp, Np = N rounded up to 64, rows past N zero), and the
//     chunk's 64 x Np float32 logits (64 KB at N 256); p is written as
//     bf16 over each row's own logits (a warp reads its whole row into
//     registers first), and the PV output over the bytes past p. 110 KB
//     at N 256: two blocks per SM;
//   - QK^T and PV as WMMA bf16 fragments, float32 accumulators; the
//     softmax in float32 between them, one warp per row, 8 columns a lane;
//   - q, k and v are staged with 4-byte cp.async copies, all in flight at
//     once (an element-wise copy loop left the block waiting on each load);
//   - the bias: rpb (heads, N, N) and the bank (2, 2, N, N) or the full
//     mask (nW, N, N) are read as given, from L2 (1.5 MB and 1 MB at HAT's
//     shape), 128 KB per block, each warp fetching its next softmax row's
//     into registers while it works on the current one (the first during
//     staging and QK^T); rebuilding rpb from the (31^2, heads) table in
//     the block would remove half of that traffic and is later work.
constexpr int WQC = 64;

__global__ void __launch_bounds__(WAT, 2) window_attention_wide_kernel(
    const __nv_bfloat16* __restrict__ qkv, const float* __restrict__ rpb,
    const float* __restrict__ bank, const float* __restrict__ mask,
    int nmask, __nv_bfloat16* __restrict__ out, int n, int C, int heads,
    int nwy, int nwx, int fast, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int hd = C / heads;
  const int hdp = (hd + 15) / 16 * 16;
  const int qld = hdp + 8;             // bf16 pitch of q, k, v
  const int np = (n + 63) / 64 * 64;   // keys, padded
  const int sld = np + 4;              // float pitch of the logits
  const int pld = 2 * sld;             // bf16 pitch of p (in place)
  const int ooff = np / 2;             // float column of the PV output
  float* Ss = reinterpret_cast<float*>(smem);
  __nv_bfloat16* Ps = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(Ss + WQC * sld);
  __nv_bfloat16* Ks = Qs + WQC * qld;
  __nv_bfloat16* Vs = Ks + np * qld;

  // one linear grid, the query chunk fastest, then the head: the blocks
  // that read one window's qkv rows run back to back and find them in L2
  const int nq = (n + WQC - 1) / WQC;
  const long long blk = blockIdx.x;
  const int q0 = static_cast<int>(blk % nq) * WQC;
  const int h = static_cast<int>((blk / nq) % heads);
  const long long win = blk / (static_cast<long long>(nq) * heads);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long base = win * n;
  const int c3 = 3 * C;
  const float* bk = window_mask(bank, mask, nmask, win, n, nwy, nwx);
  const float* rb = rpb + static_cast<long long>(h) * n * n;

  // the bias of the warp's first softmax row, in flight during staging and
  // QK^T (each warp keeps the next row's in registers: see below)
  float nr[MAXJ], nm[MAXJ];
  auto fetch_bias = [&](int i) {
    const int qi = q0 + i;
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) {
      const int c = lane + 32 * j;
      const bool in = i < WQC && qi < n && c < n;
      nr[j] = in ? rb[qi * n + c] : 0.f;
      nm[j] = in && bk != nullptr ? bk[qi * n + c] : 0.f;
    }
  };
  fetch_bias(warp);

  // 4-byte cp.async copies of bf16 pairs, every copy in flight at once
  // (the wrapper requires an even head width and a 4-byte aligned qkv, so
  // row starts and head offsets are 4-byte aligned), the zero padding
  // stored directly
  const int hp2 = hdp / 2;
  for (int e = tid; e < np * hp2; e += WAT) {
    const int i = e / hp2, d = 2 * (e % hp2);
    __nv_bfloat16* kd = Ks + i * qld + d;
    __nv_bfloat16* vd = Vs + i * qld + d;
    if (i < n && d < hd) {
      const __nv_bfloat16* row = qkv + (base + i) * c3 + h * hd + d;
      cp_async4(kd, row + C);
      cp_async4(vd, row + 2 * C);
    } else {
      *reinterpret_cast<unsigned*>(kd) = 0u;
      *reinterpret_cast<unsigned*>(vd) = 0u;
    }
  }
  for (int e = tid; e < WQC * hp2; e += WAT) {
    const int i = e / hp2, d = 2 * (e % hp2);
    __nv_bfloat16* qd = Qs + i * qld + d;
    if (q0 + i < n && d < hd)
      cp_async4(qd, qkv + (base + q0 + i) * c3 + h * hd + d);
    else
      *reinterpret_cast<unsigned*>(qd) = 0u;
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // S = q k^T: 4 x (Np / 16) fragments
  const int nfj = np / 16;
  for (int f = warp; f < 4 * nfj; f += WAT / 32) {
    const int fi = f / nfj, fj = f % nfj;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
    for (int kk = 0; kk < hdp; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          af;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major>
          bf;
      wmma::load_matrix_sync(af, Qs + fi * 16 * qld + kk, qld);
      wmma::load_matrix_sync(bf, Ks + fj * 16 * qld + kk, qld);
      wmma::mma_sync(acc, af, bf, acc);
    }
    wmma::store_matrix_sync(Ss + fi * 16 * sld + fj * 16, acc, sld,
                            wmma::mem_row_major);
  }
  __syncthreads();

  const float lscale = fast ? 1.4426950408889634f : 1.f;
  for (int i = warp; i < WQC; i += WAT / 32) {
    const int qi = q0 + i;  // uniform across the warp
    float v[MAXJ];
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) {
      const int c = lane + 32 * j;
      v[j] = qi < n && c < n
                 ? (Ss[i * sld + c] * scale + (nr[j] + nm[j])) * lscale
                 : -INFINITY;
    }
    fetch_bias(i + WAT / 32);  // the next row's, in flight meanwhile
    if (qi < n) row_softmax(v, fast);
    __syncwarp();  // every lane holds its logits before p overwrites them
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) {
      const int c = lane + 32 * j;
      if (c < np) Ps[i * pld + c] = __float2bfloat16_rn(qi < n ? v[j] : 0.f);
    }
  }
  __syncthreads();

  // O = p v: 4 x (hdp / 16) fragments, stored past p in each row
  const int nfo = 4 * (hdp / 16);
  for (int f = warp; f < nfo; f += WAT / 32) {
    const int fi = f % 4, fj = f / 4;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
    for (int kk = 0; kk < np; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          af;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          bf;
      wmma::load_matrix_sync(af, Ps + fi * 16 * pld + kk, pld);
      wmma::load_matrix_sync(bf, Vs + kk * qld + fj * 16, qld);
      wmma::mma_sync(acc, af, bf, acc);
    }
    wmma::store_matrix_sync(Ss + fi * 16 * sld + ooff + fj * 16, acc, sld,
                            wmma::mem_row_major);
  }
  __syncthreads();
  for (int e = tid; e < WQC * hd; e += WAT) {
    const int i = e / hd, d = e % hd;
    if (q0 + i < n)
      out[(base + q0 + i) * C + h * hd + d] =
          __float2bfloat16_rn(Ss[i * sld + ooff + d]);
  }
}

size_t attention_wide_smem(int n, int C, int heads) {
  const int hdp = (C / heads + 15) / 16 * 16;
  const int np = (n + 63) / 64 * 64;
  return static_cast<size_t>(WQC * (np + 4)) * 4 +
         static_cast<size_t>((WQC + 2 * np) * (hdp + 8)) * 2;
}

}  // namespace

// ldw: row pitch of the weight. For bf16 the wrapper passes the weight
// zero-padded to (Kpad, ldw), Kpad = K rounded up to 32, ldw to 64, and
// requires K % 4 == 0 and K <= 512 (the register-held A rows).
extern "C" int token_linear(const void* A, int a_dt, const void* Wt,
                            int w_dt, int ldw, const void* bias,
                            const void* R, int r_dt, void* O, int o_dt,
                            const void* ln_g, const void* ln_b, long long M,
                            int K, int N, int gelu, int B, int H, int W,
                            int ws, int dc, int a_map, int r_map, int o_map,
                            void* stream) {
  const Geom g{B, H, W, ws, dc};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lg = static_cast<const float*>(ln_g);
  const float* lb = static_cast<const float*>(ln_b);
  const float* bf = static_cast<const float*>(bias);
  if (w_dt == kBF16) {
    if (K % 4 != 0 || K > MAXK || ldw % BN != 0) return cudaErrorInvalidValue;
    const size_t smem = mma_smem_bytes(K);
    const cudaError_t e = cudaFuncSetAttribute(
        token_linear_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    const dim3 grid(static_cast<unsigned>((M + BM - 1) / BM));
    token_linear_mma_kernel<<<grid, NT, smem, s>>>(
        A, a_dt, static_cast<const __nv_bfloat16*>(Wt), ldw, bf, R, r_dt, O,
        o_dt, lg, lb, M, K, N, gelu, g, a_map, r_map, o_map);
  } else {
    const long long tiles = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
    const dim3 grid(static_cast<unsigned>(tiles));
    token_linear_kernel<<<grid, NT, 0, s>>>(
        A, a_dt, static_cast<const float*>(Wt), bf, R, r_dt, O, o_dt, lg,
        lb, M, K, N, gelu, g, a_map, r_map, o_map);
  }
  return static_cast<int>(cudaGetLastError());
}

// mask: nullptr or the (nmask, N, N) full mask (window w takes mask[w %
// nmask]); bank: nullptr or the (2, 2, N, N) edge bank. N <= 256 and head
// width <= 64; in bf16 at N > 64 an even head width and a 4-byte aligned
// qkv (the wrapper checks). scale multiplies the float32 q.k product
// before the bias is added (1 where q is pre-scaled; x * 1.0f is exact).
extern "C" int window_attention(const void* qkv, int dt, const void* rpb,
                                const void* bank, const void* mask,
                                int nmask, void* out, int nwin, int n, int C,
                                int heads, int nwy, int nwx, int fast,
                                float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > MAXN) return cudaErrorInvalidValue;
  const float* rp = static_cast<const float*>(rpb);
  const float* bp = static_cast<const float*>(bank);
  const float* mp = static_cast<const float*>(mask);
  const unsigned nq = static_cast<unsigned>((n + WQC - 1) / WQC);
  if (dt == kBF16) {
    const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(qkv);
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
    if (n <= WN) {
      const size_t smem = attention_mma_smem(C, heads);
      const cudaError_t e = cudaFuncSetAttribute(
          window_attention_mma_kernel,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
      window_attention_mma_kernel<<<nwin, WAT, smem, s>>>(
          q, rp, bp, mp, nmask, o, n, C, heads, nwy, nwx, fast, scale);
    } else {
      const size_t smem = attention_wide_smem(n, C, heads);
      const cudaError_t e = cudaFuncSetAttribute(
          window_attention_wide_kernel,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
      const unsigned blocks = static_cast<unsigned>(nwin) * heads * nq;
      window_attention_wide_kernel<<<blocks, WAT, smem, s>>>(
          q, rp, bp, mp, nmask, o, n, C, heads, nwy, nwx, fast, scale);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const int hd = C / heads;
  const int rows = n < QCF ? n : QCF;
  const size_t smem = static_cast<size_t>((rows + 2 * n) * (hd + 1) +
                                          rows * (n + 1)) *
                      sizeof(float);
  const dim3 grid(nwin, heads, (n + QCF - 1) / QCF);
  const float* q = static_cast<const float*>(qkv);
  float* o = static_cast<float*>(out);
  auto launch = [&](auto kernel, int threads) {
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    kernel<<<grid, threads, smem, s>>>(q, rp, bp, mp, nmask, o, n, C, heads,
                                       nwy, nwx, fast, scale);
    return static_cast<int>(cudaGetLastError());
  };
  if (n <= 64) return launch(window_attention_kernel, AT);
  return launch(window_attention_chunk_kernel, CAT);
}
