// K4 gdfn_block and K5 mdta_front: Restormer's fused blocks, replacing the
// TPU kernels image_restoration_agent_tpu/ops/restormer_fused.py:
// gdfn_block_pallas and mdta_block_pallas (its front, _mdta_kernel). See
// ops/restormer_fused.py for the cast points, what bounds the kernels on the
// H100 and what is left for later.
//
// A block owns a TH x TW tile of output pixels. It stages LN(x) (or x) over
// the tile and its 1-pixel halo in shared memory once, rounded to the input
// dtype. The hidden channels then go in chunks of HC: the weights are
// chunk-interleaved once per weight (ops/restormer_fused.py gdfn_weights /
// mdta_weights), so one product gives a chunk of every group (x1 and x2,
// or q, k and v) over the halo; its halo pixels outside the canvas are
// zeroed (the depthwise conv's SAME padding of the 1x1 output), the nine
// depthwise taps run from shared memory, and then
// - K4: the GELU gate (rounded to the input dtype) and a partial
//   project_out; the epilogue adds the bias and the residual in float32 and
//   casts once;
// - K5: v is written; q and k (rounded) are kept for the tile, their float32
//   sums of squares are summed per channel in a fixed order, and after the
//   last chunk the tile's per-head gram q^T k is added to the block's.
// A K5 block takes a fixed run of tiles of one sample and writes one
// partial; a second kernel sums the partials in block order (no atomics:
// the same bits every run).
//
// In bfloat16 both kernels run their products on the tensor cores
// (mma.sync m16n8k16) from pixel-major staging, on a tile chosen per C
// (ops/restormer_fused.py: gdfn_plan, mdta_plan): K4 (gdfn_mma_kernel)
// keeps project_out's accumulators in registers across the chunks, K5
// (mdta_mma_kernel) the per-head gram's across the block's run of tiles.
// In float32 both run their products on FP32 FMA, 4x4 outputs per thread,
// with channel-major staging and the float32 project_out tile or gram in
// shared memory (gdfn_kernel, mdta_front_kernel).
//
// Plain C interface for ctypes; each entry returns cudaGetLastError().

#include "common.cuh"
#include "sm90_gemm.cuh"

using namespace irk;

namespace {

constexpr int HC = 32;  // hidden channels per chunk (ops/restormer_fused.py)
constexpr int NT = 256;  // threads per block
constexpr int NW = NT / 32;

__host__ __device__ constexpr int round4(int v) { return (v + 3) / 4 * 4; }
__host__ __device__ constexpr size_t align16(size_t v) {
  return (v + 15) / 16 * 16;
}

template <typename T>
__device__ __forceinline__ float rnd(float v);
template <>
__device__ __forceinline__ float rnd<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float rnd<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
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

// four consecutive elements as floats (16-byte / 8-byte aligned)
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
// four bf16 values (low half first) as floats
__device__ __forceinline__ float4 unpack4(const uint2 r) {
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  return unpack4(*reinterpret_cast<const uint2*>(p));
}

__device__ __forceinline__ void fma4(float (&acc)[4][4], const float (&a)[4],
                                     const float4 b) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc[i][0] = fmaf(a[i], b.x, acc[i][0]);
    acc[i][1] = fmaf(a[i], b.y, acc[i][1]);
    acc[i][2] = fmaf(a[i], b.z, acc[i][2]);
    acc[i][3] = fmaf(a[i], b.w, acc[i][3]);
  }
}

// out(m, n) = sum_k A(k, m) B(k, n) in 4x4 tiles spread over the block's
// threads; A(k, m) = a[k * lda + m] when AK (k-major) else a[m * lda + k];
// B(k, n) = b[k * ldb + n]. M and N are multiples of 4; epi(m0, n0, acc)
// takes each finished tile.
template <bool AK, typename TA, typename TB, typename Epi>
__device__ __forceinline__ void mm4(const TA* __restrict__ a, int lda,
                                    const TB* __restrict__ b, int ldb, int M,
                                    int N, int K, Epi epi) {
  const int nt = N >> 2, tiles = (M >> 2) * nt;
  for (int t = threadIdx.x; t < tiles; t += NT) {
    const int m0 = (t / nt) << 2, n0 = (t % nt) << 2;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    const TA* ap = AK ? a + m0 : a + m0 * lda;
    const TB* bp = b + n0;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      float av[4];
      if constexpr (AK) {
        const float4 v = ld4(ap + k * lda);
        av[0] = v.x;
        av[1] = v.y;
        av[2] = v.z;
        av[3] = v.w;
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = to_f(ap[i * lda + k]);
      }
      fma4(acc, av, ld4(bp + static_cast<long long>(k) * ldb));
    }
    epi(m0, n0, acc);
  }
}

// n / d for 0 <= n < 2^31 by a multiply and a shift, the divisor's magic
// number made once: a division by a run-time divisor is ~20 instructions,
// and the staging, the 1x1's ring test and the taps divide per element
struct FastDiv {
  int d;
  unsigned mul, shr;
  __host__ __device__ explicit FastDiv(int div) : d(div), mul(0), shr(0) {
    if (d != 1) {
      int l = 0;
      while ((1 << l) < d) ++l;  // ceil(log2 d)
      mul = static_cast<unsigned>(((1ull << (31 + l)) + d - 1) / d);
      shr = l - 1;
    }
  }
  __device__ __forceinline__ int div(int n) const {
    return d == 1 ? n
                  : static_cast<int>(
                        __umulhi(static_cast<unsigned>(n), mul) >> shr);
  }
};

// Tile geometry: halo pixel m = hy * (TW + 2) + hx sits at canvas pixel
// (y0 + hy - 1, x0 + hx - 1).
struct Tile {
  int TH, TW, hw2, hp, hpp, tp, H, W, y0, x0;
  long long b;
  __device__ Tile(int th, int tw, int h, int w, long long bb, int yy,
                  int xx)
      : TH(th), TW(tw), hw2(tw + 2), hp((th + 2) * (tw + 2)),
        hpp(round4((th + 2) * (tw + 2))), tp(th * tw), H(h), W(w), y0(yy),
        x0(xx), b(bb) {}
  __device__ bool halo_in(int m) const {
    const int gy = y0 + m / hw2 - 1, gx = x0 + m % hw2 - 1;
    return m < hp && gy >= 0 && gy < H && gx >= 0 && gx < W;
  }
  __device__ long long halo_src(int m) const {
    return (b * H + y0 + m / hw2 - 1) * W + x0 + m % hw2 - 1;
  }
  __device__ bool out_in(int p) const {
    return y0 + p / TW < H && x0 + p % TW < W;
  }
  __device__ long long out_pix(int p) const {
    return (b * H + y0 + p / TW) * W + x0 + p % TW;
  }
};

// The tensor-core kernels' tile: the divisions by TW + 2 and TW as
// multiply-shifts with dividers made once per kernel (the float32 kernels'
// tiles are small and keep Tile: the dividers cost them registers)
struct FastTile : Tile {
  FastDiv f2, fw;
  __device__ FastTile(int th, int tw, int h, int w, long long bb, int yy,
                      int xx, const FastDiv& by2, const FastDiv& byw)
      : Tile(th, tw, h, w, bb, yy, xx), f2(by2), fw(byw) {}
  __device__ bool halo_in(int m) const {
    const int hy = f2.div(m);
    const int gy = y0 + hy - 1, gx = x0 + m - hy * hw2 - 1;
    return m < hp && gy >= 0 && gy < H && gx >= 0 && gx < W;
  }
  __device__ long long halo_src(int m) const {
    const int hy = f2.div(m);
    return (b * H + y0 + hy - 1) * W + x0 + m - hy * hw2 - 1;
  }
  __device__ bool out_in(int p) const {
    const int r = fw.div(p);
    return y0 + r < H && x0 + p - r * TW < W;
  }
  __device__ long long out_pix(int p) const {
    const int r = fw.div(p);
    return (b * H + y0 + r) * W + x0 + p - r * TW;
  }
};

// LN(x) (ln_mode 2: WithBias, 1: BiasFree, 0: none) over the halo into
// xs[c * hpp + m], rounded to T, 0 outside the canvas. A warp per pixel:
// float32 two-pass statistics, eps 1e-5.
template <typename T>
__device__ void stage_ln(const T* __restrict__ x,
                         const float* __restrict__ ln_w,
                         const float* __restrict__ ln_b, int ln_mode, T* xs,
                         const Tile& t, int C) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int m = warp; m < t.hpp; m += NW) {
    if (!t.halo_in(m)) {
      for (int c = lane; c < C; c += 32) xs[c * t.hpp + m] = from_f<T>(0.f);
      continue;
    }
    const T* px = x + t.halo_src(m) * C;
    float mu = 0.f, rs = 1.f;
    if (ln_mode != 0) {
      float s = 0.f;
      for (int c = lane; c < C; c += 32) s += to_f(px[c]);
      mu = warp_sum(s) / C;
      float v = 0.f;
      for (int c = lane; c < C; c += 32) {
        const float d = to_f(px[c]) - mu;
        v += d * d;
      }
      rs = rsqrtf(warp_sum(v) / C + 1e-5f);
    }
    for (int c = lane; c < C; c += 32) {
      const float v = to_f(px[c]);
      float y = v;
      if (ln_mode == 2)
        y = (v - mu) * rs * ln_w[c] + ln_b[c];
      else if (ln_mode == 1)
        y = v * rs * ln_w[c];
      xs[c * t.hpp + m] = from_f<T>(y);
    }
  }
}

// The chunk's 1x1 over the halo: u[m * ldu + n] = round(xs^T w + bias), 0
// outside the canvas; w and bias start at the chunk's first column.
template <typename T>
__device__ __forceinline__ void one_by_one(const T* xs, const T* w, int ldw,
                                           const float* bias, float* u,
                                           int ldu, const Tile& t, int C) {
  mm4<true>(xs, t.hpp, w, ldw, t.hpp, ldu, C,
            [&](int m0, int n0, float (&a)[4][4]) {
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const int m = m0 + i;
                const bool in = t.halo_in(m);
                float r[4];
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                  const float v = a[i][j] + (bias ? bias[n0 + j] : 0.f);
                  r[j] = in ? rnd<T>(v) : 0.f;
                }
                *reinterpret_cast<float4*>(u + m * ldu + n0) =
                    make_float4(r[0], r[1], r[2], r[3]);
              }
            });
}

// Nine taps of column j of u for four outputs (r, q..q+3), float32, summed
// in the TPU kernel's order (dy, then dx), bias after.
__device__ __forceinline__ void dw4(const float* u, int ldu, int hw2, int r,
                                    int q, int j, const float (&w)[9],
                                    float bias, float (&d)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] = 0.f;
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    const float* row = u + ((r + dy) * hw2 + q) * ldu + j;
    float a[6];
#pragma unroll
    for (int s = 0; s < 6; ++s) a[s] = row[s * ldu];
#pragma unroll
    for (int dx = 0; dx < 3; ++dx)
#pragma unroll
      for (int i = 0; i < 4; ++i) d[i] = fmaf(a[i + dx], w[dy * 3 + dx], d[i]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += bias;
}

__device__ __forceinline__ void load_taps(const float* w_dw, int ldw,
                                          int col, float (&w)[9]) {
#pragma unroll
  for (int s = 0; s < 9; ++s) w[s] = w_dw[s * ldw + col];
}

// ---------------------------------------------------------------------------
// K4: x + project_out(gelu(dw(1x1_a(LN x))) * dw(1x1_b(LN x)))

template <typename T>
__global__ void __launch_bounds__(NT) gdfn_kernel(
    const T* __restrict__ x, const float* __restrict__ ln_w,
    const float* __restrict__ ln_b, const T* __restrict__ w_in,
    const float* __restrict__ b_in, const float* __restrict__ w_dw,
    const float* __restrict__ b_dw, const T* __restrict__ w_out,
    const float* __restrict__ b_out, T* __restrict__ out, int H, int W,
    int C, int NCH, int ln_mode, int fast, int TH, int TW) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ntx = (W + TW - 1) / TW, nty = (H + TH - 1) / TH;
  const int tx = blockIdx.x % ntx, ty = (blockIdx.x / ntx) % nty;
  const Tile t(TH, TW, H, W, blockIdx.x / (ntx * nty), ty * TH, tx * TW);
  const int cp = round4(C), ldw = NCH * 2 * HC, gl = HC + 1;
  T* xs = reinterpret_cast<T*>(smem);                      // [C][hpp]
  float* u = reinterpret_cast<float*>(
      smem + align16(sizeof(T) * C * t.hpp));               // [hpp][2HC]
  float* g = u + t.hpp * 2 * HC;                            // [tp][HC+1]
  float* acc = g + round4(t.tp * gl);                       // [tp][cp]

  stage_ln(x, ln_w, ln_b, ln_mode, xs, t, C);
  for (int e = threadIdx.x; e < t.tp * cp; e += NT) acc[e] = 0.f;

  const int j = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int qs = TW / 4, segs = TH * qs;
  for (int ci = 0; ci < NCH; ++ci) {
    const int col0 = ci * 2 * HC;
    __syncthreads();
    one_by_one(xs, w_in + col0, ldw, b_in ? b_in + col0 : nullptr, u,
               2 * HC, t, C);
    __syncthreads();
    float w1[9], w2[9];
    load_taps(w_dw, ldw, col0 + j, w1);
    load_taps(w_dw, ldw, col0 + HC + j, w2);
    const float c1 = b_dw ? b_dw[col0 + j] : 0.f;
    const float c2 = b_dw ? b_dw[col0 + HC + j] : 0.f;
    for (int s = warp; s < segs; s += NW) {
      const int r = s / qs, q = (s % qs) * 4;
      float d1[4], d2[4];
      dw4(u, 2 * HC, t.hw2, r, q, j, w1, c1, d1);
      dw4(u, 2 * HC, t.hw2, r, q, HC + j, w2, c2, d2);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float v = d1[i];
        const float ge =
            fast ? 0.5f * v *
                       (1.f + tanhf(0.7978845608028654f *
                                    (v + 0.044715f * v * v * v)))
                 : 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
        g[(r * TW + q + i) * gl + j] = rnd<T>(ge * d2[i]);
      }
    }
    __syncthreads();
    mm4<false>(g, gl, w_out + static_cast<long long>(ci) * HC * cp, cp,
               t.tp, cp, HC, [&](int m0, int n0, float (&a)[4][4]) {
#pragma unroll
                 for (int i = 0; i < 4; ++i) {
                   float4* p =
                       reinterpret_cast<float4*>(acc + (m0 + i) * cp + n0);
                   float4 v = *p;
                   v.x += a[i][0];
                   v.y += a[i][1];
                   v.z += a[i][2];
                   v.w += a[i][3];
                   *p = v;
                 }
               });
  }
  __syncthreads();
  for (int e = threadIdx.x; e < t.tp * C; e += NT) {
    const int p = e / C, n = e - p * C;
    if (!t.out_in(p)) continue;
    const long long o = t.out_pix(p) * C + n;
    float v = acc[p * cp + n];
    if (b_out) v += b_out[n];
    out[o] = from_f<T>(v + to_f(x[o]));
  }
}

// ---------------------------------------------------------------------------
// The tensor-core kernels' shared pieces (K4 and K5 in bfloat16).
//
// A block stages x over a tile's halo pixel-major in bf16: xs [hpr][ldx]
// (hpr = hp rounded up to 16 rows, ldx = C rounded up to 16, + 8 so that
// ldmatrix rows hit every bank once), 0 outside the canvas, past C and past
// hp. x's rows arrive by cp.async, all in flight at once, and are
// normalized in place (a warp per pixel reading device memory three times
// in turn was a third of K4's time at C 48). A 1x1 over the halo runs as
// (m16 tile, 32 columns) tasks on mma.sync m16n8k16: A by ldmatrix from xs,
// B as mma fragments read from a packed weight form in device memory
// (ops/restormer_fused.py:frag_pack: 256 contiguous bytes a warp, one
// 8-byte load a lane; L1 keeps a chunk's weights for every task); bias,
// ring pixels outside the canvas zeroed, rounded to bf16 into a u tile
// [hp][ldu]. The depthwise taps then run a lane per pair of channels, two
// rows of four pixels a step, float32 sums in the TPU kernel's order.

using bf = __nv_bfloat16;

// how x's rows are copied: w-byte pieces (16, or 8 where x or a row is not
// 16-byte aligned), segs a row, and the row's c16 / 4 quads to zero
struct HaloCopy {
  int w, segs, q4;
  FastDiv fs, fq;
  __device__ HaloCopy(const bf* x, int C)
      : w((static_cast<int>(reinterpret_cast<uintptr_t>(x)) | (2 * C)) & 15
              ? 8
              : 16),
        segs(2 * C / w), q4(((C + 15) & ~15) / 4), fs(segs), fq(q4) {}
};

// issue the copies of x's halo rows into xs (cp.async, one committed
// group) and zero what lies outside the canvas or past C
__device__ __forceinline__ void stage_halo(const bf* __restrict__ x, bf* xs,
                                           const FastTile& t, int C, int ldx,
                                           int hpr, const HaloCopy& hc) {
  const int we = hc.w / 2;
  for (int e = threadIdx.x; e < hpr * hc.segs; e += blockDim.x) {
    const int m = hc.fs.div(e), sg = e - m * hc.segs;
    if (t.halo_in(m))
      cp_async_w(xs + m * ldx + sg * we, x + t.halo_src(m) * C + sg * we,
                 hc.w);
  }
  cp_async_commit();
  for (int e = threadIdx.x; e < hpr * hc.q4; e += blockDim.x) {
    const int m = hc.fq.div(e), c = 4 * (e - m * hc.q4);
    if (!t.halo_in(m) || c >= C)
      *reinterpret_cast<uint2*>(xs + m * ldx + c) = make_uint2(0u, 0u);
  }
}

// LN (ln_mode 2: WithBias, 1: BiasFree; weights in device or shared
// memory) of the staged halo in place, after the copies landed and a
// barrier: LP lanes a pixel, the fewest (a power of
// two) that leave a lane at most 6 quads of channels, which it reads once
// into registers; float32 two-pass statistics from the registers, eps
// 1e-5, one write. (A warp per pair of pixels reading each row three times
// was a quarter of K5's time at C 48 and C 96; 12 quads a lane made K5
// spill more at C 192 and 384.)
__device__ void ln_in_place(bf* xs, const float* ln_w, const float* ln_b,
                            int ln_mode, const FastTile& t, int C, int ldx,
                            int hpr) {
  constexpr int QMAX = 6;
  const int nq = C / 4;
  int lp = 1;
  while (lp * QMAX < nq) lp <<= 1;
  const int sub = threadIdx.x & (lp - 1), ppb = blockDim.x / lp;
  // every lane runs every pass: the statistics are summed by shuffles
  for (int m0 = 0; m0 < hpr; m0 += ppb) {
    const int m = m0 + threadIdx.x / lp;
    const bool ok = m < hpr && t.halo_in(m);
    bf* row = xs + (ok ? m : 0) * ldx;
    uint2 v[QMAX];
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < QMAX; ++k) {
      const int q = sub + lp * k;
      v[k] = ok && q < nq ? *reinterpret_cast<const uint2*>(row + 4 * q)
                          : make_uint2(0u, 0u);
      const float4 f = unpack4(v[k]);
      s += (f.x + f.y) + (f.z + f.w);
    }
    for (int o = 1; o < lp; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    const float mu = s / C;
    float v2 = 0.f;
#pragma unroll
    for (int k = 0; k < QMAX; ++k) {
      if (sub + lp * k >= nq) continue;
      const float4 f = unpack4(v[k]);
      const float d0 = f.x - mu, d1 = f.y - mu, d2 = f.z - mu, d3 = f.w - mu;
      v2 += (d0 * d0 + d1 * d1) + (d2 * d2 + d3 * d3);
    }
    for (int o = 1; o < lp; o <<= 1)
      v2 += __shfl_xor_sync(0xffffffffu, v2, o);
    const float rs = rsqrtf(v2 / C + 1e-5f);
    if (!ok) continue;
#pragma unroll
    for (int k = 0; k < QMAX; ++k) {
      const int q = sub + lp * k;
      if (q >= nq) continue;
      const float4 f = unpack4(v[k]);
      const float4 w4 = reinterpret_cast<const float4*>(ln_w)[q];
      const float4 b4 = ln_mode == 2 ? reinterpret_cast<const float4*>(ln_b)[q]
                                     : make_float4(0.f, 0.f, 0.f, 0.f);
      const float y0 = ln_mode == 2 ? (f.x - mu) * rs * w4.x + b4.x
                                    : f.x * rs * w4.x;
      const float y1 = ln_mode == 2 ? (f.y - mu) * rs * w4.y + b4.y
                                    : f.y * rs * w4.y;
      const float y2 = ln_mode == 2 ? (f.z - mu) * rs * w4.z + b4.z
                                    : f.z * rs * w4.z;
      const float y3 = ln_mode == 2 ? (f.w - mu) * rs * w4.w + b4.w
                                    : f.w * rs * w4.w;
      *reinterpret_cast<uint2*>(row + 4 * q) =
          make_uint2(pack_bf16(y0, y1), pack_bf16(y2, y3));
    }
  }
}

// d[i] = 16 halo rows (m16 tile i of nt <= QT consecutive ones, A by
// ldmatrix from arow + 16 i lda, this lane's row and k half) times 4
// consecutive n8 tiles of a packed weight: wb is this lane's fragment of k
// step 0's first tile (device or shared memory), kstride the n8 tiles a k
// step; each B fragment feeds the QT tiles
template <int QT>
__device__ __forceinline__ void mma_rows_x32(float (&d)[QT][4][4],
                                             const bf* arow, int lda, int nt,
                                             int ks_n, const uint2* wb,
                                             int kstride) {
#pragma unroll
  for (int i = 0; i < QT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      d[i][j][0] = d[i][j][1] = d[i][j][2] = d[i][j][3] = 0.f;
  // the next k step's fragments are in flight while this one's run
  uint2 bv[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) bv[j] = wb[j * 32];
  for (int ks = 0; ks < ks_n; ++ks) {
    uint2 bn[4];
    if (ks + 1 < ks_n) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        bn[j] = wb[((ks + 1) * kstride + j) * 32];
    }
#pragma unroll
    for (int i = 0; i < QT; ++i) {
      if (i >= nt) break;
      uint32_t a[4];
      ldmatrix_x4(a, arow + 16 * i * lda + 16 * ks);
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_bf16(d[i][j], a, bv[j].x, bv[j].y);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = bn[j];
  }
}

// a 16 x 32 product of halo m16 tile mt into u at columns col0 ..: + bias
// (float32 from the chunk's first column, or none), 0 at pixels outside
// the canvas, rounded to bf16
__device__ __forceinline__ void store_halo_u(bf* us, int ldu, int col0,
                                             const float* __restrict__ bias,
                                             const float (&d)[4][4],
                                             const FastTile& t, int mt,
                                             int lane) {
  const int g = lane >> 2, t4 = lane & 3;
  // this lane's two rows: in the halo and on the canvas
  bool keep[2], in[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int m = 16 * mt + g + 8 * r;
    keep[r] = m < t.hp;
    in[r] = t.halo_in(m);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = col0 + 8 * j + 2 * t4;
    const float2 bi = bias != nullptr
                          ? *reinterpret_cast<const float2*>(bias + col)
                          : make_float2(0.f, 0.f);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (!keep[r]) continue;
      *reinterpret_cast<uint32_t*>(us + (16 * mt + g + 8 * r) * ldu + col) =
          in[r] ? pack_bf16(d[j][2 * r] + bi.x, d[j][2 * r + 1] + bi.y) : 0u;
    }
  }
}

// the nine taps of a channel pair (weights wa, wb, biases ca, cb) for two
// output rows of four pixels: base is u at halo row r, pixel q, the pair's
// column; halo rows r .. r + 3 feed output rows r (taps dy) and r + 1
// (taps dy - 1), each summed in the order dy, dx, bias after
__device__ __forceinline__ void taps_2x4(const bf* base, int hw2, int ldu,
                                         const float (&wa)[9],
                                         const float (&wb)[9], float ca,
                                         float cb, float2 (&d)[2][4]) {
#pragma unroll
  for (int o = 0; o < 2; ++o)
#pragma unroll
    for (int i = 0; i < 4; ++i) d[o][i] = make_float2(0.f, 0.f);
#pragma unroll
  for (int dy = 0; dy < 4; ++dy) {
    const bf* row = base + dy * hw2 * ldu;
    float2 av[6];
#pragma unroll
    for (int k = 0; k < 6; ++k)
      av[k] = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(row + k * ldu));
#pragma unroll
    for (int dx = 0; dx < 3; ++dx)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (dy < 3) {
          d[0][i].x = fmaf(av[i + dx].x, wa[dy * 3 + dx], d[0][i].x);
          d[0][i].y = fmaf(av[i + dx].y, wb[dy * 3 + dx], d[0][i].y);
        }
        if (dy > 0) {
          d[1][i].x = fmaf(av[i + dx].x, wa[(dy - 1) * 3 + dx], d[1][i].x);
          d[1][i].y = fmaf(av[i + dx].y, wb[(dy - 1) * 3 + dx], d[1][i].y);
        }
      }
  }
#pragma unroll
  for (int o = 0; o < 2; ++o)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      d[o][i].x += ca;
      d[o][i].y += cb;
    }
}

// ---------------------------------------------------------------------------
// K4, bfloat16: both 1x1 products on the tensor cores (mma.sync m16n8k16,
// float32 accumulators), the depthwise 3x3 and the GELU gate on FP32 FMA.
//
// A block of NTH = 32 * NW threads owns a TH x TW output tile (tp = TH TW
// pixels, hp = (TH+2)(TW+2) halo pixels):
//   - xs: LN(x) over the halo (stage_halo, ln_in_place);
//   - per hidden chunk of HC: project_in as (m16 tile, x1 or x2 half)
//     tasks over the warps into us [hp][2 HC + 8] (at C <= 64 a warp keeps
//     its half's B fragments of every k step in registers);
//   - the nine taps and the gate, a lane per pair of hidden channels of
//     x1 or x2, 2 x 4 pixels a step (taps_2x4), the gate rounded to bf16
//     into gs [tp][HC + 8];
//   - project_out: warp w owns rows 16 (MT wm .. MT wm + MT - 1) and
//     columns 8 (NTW wn .. NTW wn + NTW - 1) of the (tp, C) output (wm = w
//     % WM, wn = w / WM, WM WN = NW), A by ldmatrix from gs, B fragments
//     from the packed w_out; its accumulators stay in registers across
//     every chunk (MT NTW 4 = 48 floats a thread);
//   - the epilogue adds b_out and the residual in float32 and stores bf16
//     pairs.
// Two barriers a chunk: project_in writes us after the previous chunk's
// taps read it; the taps write gs after the previous project_out read it.
// tanh(u) = 1 - 2 / (e^2u + 1) in float32: within ~1e-7 of tanhf over
// the whole range (+-1 where e^2u overflows or vanishes) at a quarter of
// its instructions; the gate it feeds is rounded to bf16
__device__ __forceinline__ float tanh_f32(float u) {
  return 1.f - __fdividef(2.f, __expf(2.f * u) + 1.f);
}

template <int MT, int NTW>
__global__ void __launch_bounds__(512, 1) gdfn_mma_kernel(
    const bf* __restrict__ x, const float* __restrict__ ln_w,
    const float* __restrict__ ln_b, const uint2* __restrict__ w_in,
    const float* __restrict__ b_in, const float* __restrict__ w_dw,
    const float* __restrict__ b_dw, const uint2* __restrict__ w_out,
    const float* __restrict__ b_out, bf* __restrict__ out, int H, int W,
    int C, int NCH, int ln_mode, int fast, int TH, int TW, int WN) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nw = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int ntx = (W + TW - 1) / TW, nty = (H + TH - 1) / TH;
  const int tx = blockIdx.x % ntx, ty = (blockIdx.x / ntx) % nty;
  const FastTile t(TH, TW, H, W, blockIdx.x / (ntx * nty), ty * TH, tx * TW,
                   FastDiv(TW + 2), FastDiv(TW));
  const int c16 = (C + 15) & ~15, ldx = c16 + 8, hpr = (t.hp + 15) & ~15;
  constexpr int LDU = 2 * HC + 8, LDG = HC + 8;
  bf* xs = reinterpret_cast<bf*>(smem);
  bf* us = xs + hpr * ldx;
  bf* gs = us + t.hp * LDU;

  stage_halo(x, xs, t, C, ldx, hpr, HaloCopy(x, C));
  cp_async_wait<0>();
  __syncthreads();
  if (ln_mode != 0) ln_in_place(xs, ln_w, ln_b, ln_mode, t, C, ldx, hpr);

  const int wm = warp % (nw / WN), wn = warp / (nw / WN);
  const int ks_in = c16 / 16, nto = NTW * WN;
  float acc[MT][NTW][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NTW; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
  const int fr = frag_row(lane), fk = 8 * frag_khalf(lane);
  const int qs = TW / 4, segs2 = TH / 2 * qs;
  const FastDiv fqs(qs);

  for (int ci = 0; ci < NCH; ++ci) {
    __syncthreads();  // xs staged / the previous chunk's taps read us
    // project_in over the halo: (m16 tile, x1 or x2 half) tasks; bias,
    // ring zeroed, rounded to bf16 into us
    const uint2* wc = w_in + static_cast<long long>(ci) * ks_in * 8 * 32;
    const float* bc_in = b_in != nullptr ? b_in + ci * 2 * HC : nullptr;
    if (ks_in <= 4) {
      // C <= 64: warp w keeps half w % 2's B fragments of every k step in
      // registers for all its m16 tiles
      const int half = warp & 1;
      uint2 bc[4][4];
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          bc[ks][j] = ks < ks_in
                          ? __ldg(wc + (ks * 8 + half * 4 + j) * 32 + lane)
                          : make_uint2(0u, 0u);
      for (int mt = warp >> 1; mt < hpr / 16; mt += nw >> 1) {
        float d[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          d[j][0] = d[j][1] = d[j][2] = d[j][3] = 0.f;
        const bf* arow = xs + (16 * mt + fr) * ldx + fk;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          if (ks >= ks_in) break;
          uint32_t a[4];
          ldmatrix_x4(a, arow + 16 * ks);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            mma_bf16(d[j], a, bc[ks][j].x, bc[ks][j].y);
        }
        store_halo_u(us, LDU, half * HC, bc_in, d, t, mt, lane);
      }
    } else {
      for (int task = warp; task < (hpr / 16) * 2; task += nw) {
        const int mt = task >> 1, half = task & 1;
        float d[1][4][4];
        mma_rows_x32<1>(d, xs + (16 * mt + fr) * ldx + fk, ldx, 1, ks_in,
                        wc + half * 4 * 32 + lane, 8);
        store_halo_u(us, LDU, half * HC, bc_in, d[0], t, mt, lane);
      }
    }
    __syncthreads();
    // the nine taps and the gate: lane l takes hidden channels 2 (l % 16)
    // and + 1 of x1 (l < 16) or x2 (l >= 16), two rows of four pixels a
    // step; the two halves swap one row's sums, and each computes the
    // gate of one row
    {
      const int half = lane >> 4, cp = 2 * (lane & 15);
      const int col = ci * 2 * HC + half * HC + cp;
      float wa[9], wb[9];
      load_taps(w_dw, NCH * 2 * HC, col, wa);
      load_taps(w_dw, NCH * 2 * HC, col + 1, wb);
      const float ca = b_dw ? b_dw[col] : 0.f;
      const float cb = b_dw ? b_dw[col + 1] : 0.f;
      for (int s = warp; s < segs2; s += nw) {
        const int sr = fqs.div(s), r = 2 * sr, q = (s - sr * qs) * 4;
        float2 d[2][4];
        taps_2x4(us + (r * t.hw2 + q) * LDU + half * HC + cp, t.hw2, LDU, wa,
                 wb, ca, cb, d);
        // half 0 gates row r (it sends x1 of row r + 1), half 1 gates row
        // r + 1 (it sends x2 of row r)
        float2 got[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 snd = half ? d[0][i] : d[1][i];
          got[i].x = __shfl_xor_sync(0xffffffffu, snd.x, 16);
          got[i].y = __shfl_xor_sync(0xffffffffu, snd.y, 16);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 x1 = half ? got[i] : d[0][i];
          const float2 x2 = half ? d[1][i] : got[i];
          float gv[2];
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const float v = k ? x1.y : x1.x;
            const float ge =
                fast ? 0.5f * v *
                           (1.f + tanh_f32(0.7978845608028654f *
                                           (v + 0.044715f * v * v * v)))
                     : 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
            gv[k] = ge * (k ? x2.y : x2.x);
          }
          *reinterpret_cast<uint32_t*>(
              gs + ((r + half) * TW + q + i) * LDG + cp) =
              pack_bf16(gv[0], gv[1]);
        }
      }
    }
    __syncthreads();
    // project_out, accumulated in registers
    const uint2* wo = w_out + static_cast<long long>(ci) * 2 * nto * 32;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldmatrix_x4(a[i], gs + (16 * (MT * wm + i) + fr) * LDG + 16 * ks + fk);
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        const uint2 b = __ldg(wo + (ks * nto + NTW * wn + j) * 32 + lane);
#pragma unroll
        for (int i = 0; i < MT; ++i) mma_bf16(acc[i][j], a[i], b.x, b.y);
      }
    }
  }

#pragma unroll
  for (int j = 0; j < NTW; ++j) {
    const int col = 8 * (NTW * wn + j) + 2 * t4;
    if (col >= C) continue;
    const float2 bo = b_out != nullptr
                          ? *reinterpret_cast<const float2*>(b_out + col)
                          : make_float2(0.f, 0.f);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int p = 16 * (MT * wm + i) + g + 8 * r;
        if (p >= t.tp || !t.out_in(p)) continue;
        const long long o = t.out_pix(p) * C + col;
        const float2 xr = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(x + o));
        *reinterpret_cast<uint32_t*>(out + o) =
            pack_bf16((acc[i][j][2 * r] + bo.x) + xr.x,
                      (acc[i][j][2 * r + 1] + bo.y) + xr.y);
      }
  }
}

size_t gdfn_mma_smem(int C, int TH, int TW) {
  const size_t hp = static_cast<size_t>(TH + 2) * (TW + 2);
  const size_t hpr = (hp + 15) / 16 * 16, c16 = (C + 15) / 16 * 16;
  return 2 * (hpr * (c16 + 8) + hp * (2 * HC + 8) +
              static_cast<size_t>(TH) * TW * (HC + 8));
}

// ---------------------------------------------------------------------------
// K5: MDTA's front: v, and per block the per-head gram and sums of squares

template <typename T>
__global__ void __launch_bounds__(NT) mdta_front_kernel(
    const T* __restrict__ x, const float* __restrict__ ln_w,
    const float* __restrict__ ln_b, const T* __restrict__ w_qkv,
    const float* __restrict__ b_qkv, const float* __restrict__ w_dw,
    const float* __restrict__ b_dw, T* __restrict__ v_out,
    float* __restrict__ part, int H, int W, int C, int NCH, int heads,
    int ln_mode, int TH, int TW, int NB) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ntx = (W + TW - 1) / TW, nty = (H + TH - 1) / TH;
  const int ntiles = ntx * nty;
  const long long b = blockIdx.x / NB;
  const int ib = blockIdx.x % NB;
  const int t0 = static_cast<int>(static_cast<long long>(ntiles) * ib / NB);
  const int t1 =
      static_cast<int>(static_cast<long long>(ntiles) * (ib + 1) / NB);
  const int cq = NCH * HC, ch = C / heads, gs = heads * ch * ch;
  const int ldw = NCH * 3 * HC, hpp = round4((TH + 2) * (TW + 2));
  const int tp = TH * TW;
  T* xs = reinterpret_cast<T*>(smem);                       // [C][hpp]
  unsigned char* p1 = smem + align16(sizeof(T) * C * hpp);
  float* u = reinterpret_cast<float*>(p1);                  // [hpp][3HC]
  T* qs = reinterpret_cast<T*>(p1 + sizeof(float) * hpp * 3 * HC);  // [tp][cq]
  T* ks = qs + align16(sizeof(T) * tp * cq) / sizeof(T);             // [tp][cq]
  float* gm = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(ks) + align16(sizeof(T) * tp * cq));
  float* ssq = gm + gs;                                     // [2][cq]
  float* red = ssq + 2 * cq;                                // [2][NW][HC]

  for (int e = threadIdx.x; e < gs + 2 * cq; e += NT) gm[e] = 0.f;

  const int j = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nq = TW / 4, segs = TH * nq;
  for (int tile = t0; tile < t1; ++tile) {
    const Tile t(TH, TW, H, W, b, (tile / ntx) * TH, (tile % ntx) * TW);
    __syncthreads();
    stage_ln(x, ln_w, ln_b, ln_mode, xs, t, C);
    for (int ci = 0; ci < NCH; ++ci) {
      const int col0 = ci * 3 * HC, cj = ci * HC + j;
      __syncthreads();
      one_by_one(xs, w_qkv + col0, ldw, b_qkv ? b_qkv + col0 : nullptr, u,
                 3 * HC, t, C);
      __syncthreads();
      float sums[2] = {0.f, 0.f};
#pragma unroll
      for (int grp = 0; grp < 3; ++grp) {
        float w[9];
        load_taps(w_dw, ldw, col0 + grp * HC + j, w);
        const float bias = b_dw ? b_dw[col0 + grp * HC + j] : 0.f;
        for (int s = warp; s < segs; s += NW) {
          const int r = s / nq, q = (s % nq) * 4;
          float d[4];
          dw4(u, 3 * HC, t.hw2, r, q, grp * HC + j, w, bias, d);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int p = r * TW + q + i;
            const bool in = t.out_in(p);
            if (grp == 2) {
              if (in && cj < C) v_out[t.out_pix(p) * C + cj] = from_f<T>(d[i]);
            } else {
              const float v = in ? d[i] : 0.f;
              (grp == 0 ? qs : ks)[p * cq + cj] = from_f<T>(v);
              sums[grp] += v * v;
            }
          }
        }
      }
      red[warp * HC + j] = sums[0];
      red[(NW + warp) * HC + j] = sums[1];
      __syncthreads();
      if (threadIdx.x < 2 * HC) {
        const int which = threadIdx.x / HC, jj = threadIdx.x % HC;
        float s = 0.f;
        for (int w = 0; w < NW; ++w) s += red[(which * NW + w) * HC + jj];
        ssq[which * cq + ci * HC + jj] += s;
      }
    }
    __syncthreads();
    // this tile's share of the per-head gram: gm[h][c][d] += q_h^T k_h
    const int nt = ch >> 2, per = nt * nt;
    for (int e = threadIdx.x; e < heads * per; e += NT) {
      const int hh = e / per, m0 = ((e % per) / nt) << 2,
                n0 = ((e % per) % nt) << 2;
      const T* ap = qs + hh * ch + m0;
      const T* bp = ks + hh * ch + n0;
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jx = 0; jx < 4; ++jx) acc[i][jx] = 0.f;
#pragma unroll 4
      for (int p = 0; p < tp; ++p) {
        const float4 av = ld4(ap + p * cq);
        const float a4[4] = {av.x, av.y, av.z, av.w};
        fma4(acc, a4, ld4(bp + p * cq));
      }
      float* gp = gm + hh * ch * ch;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jx = 0; jx < 4; ++jx) gp[(m0 + i) * ch + n0 + jx] += acc[i][jx];
    }
  }
  __syncthreads();
  float* dst = part + static_cast<long long>(blockIdx.x) * (gs + 2 * cq);
  for (int e = threadIdx.x; e < gs + 2 * cq; e += NT) dst[e] = gm[e];
}

// gram[b] and ssq[b]: the per-block partials of sample b summed in block
// order
__global__ void mdta_reduce_kernel(const float* __restrict__ part,
                                   float* __restrict__ gram,
                                   float* __restrict__ ssq, int NB, int gs,
                                   int cq, int C, long long total) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (e >= total) return;
  const int per = gs + 2 * C;
  const long long b = e / per;
  const int off = static_cast<int>(e % per);
  const int src = off < gs ? off : gs + (off - gs) / C * cq + (off - gs) % C;
  const float* p = part + b * NB * (gs + 2 * cq) + src;
  float s = 0.f;
  for (int i = 0; i < NB; ++i) s += p[static_cast<long long>(i) * (gs + 2 * cq)];
  if (off < gs)
    gram[b * gs + off] = s;
  else
    ssq[b * 2 * C + off - gs] = s;
}

// ---------------------------------------------------------------------------
// K5, bfloat16: both products on the tensor cores (mma.sync m16n8k16,
// float32 accumulators), the per-head gram accumulated in registers across
// the block's whole run of tiles.
//
// A block of NTH = 32 * NW threads takes a fixed run of TH x TW tiles of
// one sample. Per tile:
//   - xs: LN(x) over the halo (stage_halo, ln_in_place); the copies of the
//     next tile's halo are issued as soon as this tile's last qkv product
//     has read xs, so they land while the last chunk's taps and the gram
//     run;
//   - per chunk of HC channels: the qkv 1x1 as (QT m16 tiles, q, k or v)
//     tasks into us [hp][3 HC + 8] (mma_rows_x32 from the packed w_qkv_f:
//     chunk i's 96 interleaved columns);
//   - the nine taps, a half-warp per (q, k or v, two rows of four pixels)
//     unit, a lane per channel pair (taps_2x4): v to device memory in
//     bf16; q and k rounded to bf16 into qs, ks [tp][ldq] (0 at pixels
//     outside the canvas; head h's channels at columns h chp .., chp = the
//     head width rounded up to 16, so every head starts 16-byte aligned);
//     the float32 sums of squares of q and k per lane in registers, summed
//     over the warps in a fixed order after the next barrier;
//   - the gram: warp w owns a gram tile of MW x NW8 (m16, n8) tiles of one
//     head (gram_tile_of); A = q_h^T and B = k_h come by ldmatrix.trans
//     from the pixel-major tiles (gram_step). Only the per-head diagonal
//     blocks are computed. The gram tile is the smallest of 1x2, 1x3, 3x2
//     and 3x3 whose tiles the warps hold (ops/restormer_fused.py:
//     mdta_plan), so no warp takes two: the accumulators stay live through
//     every phase, and 36 of them a thread made the taps spill at 128
//     registers; the first three run 384-thread blocks (168 registers, no
//     spills), 3x3 (C 384, 8 heads) 512.
// After the last tile the block writes one partial (rows and columns past
// the head width dropped); mdta_reduce_kernel sums the partials in block
// order. When a sample's gram tiles outnumber the warps, GS blocks share a
// run of tiles, each holding its slice of the gram tiles (only slice 0
// writes v and the sums of squares).
// the gram tile shapes (m16 x n8 mma tiles) K5 is instantiated for, each
// with its block size: 384 threads (168 registers a thread) where 12 warps
// hold the gram tiles, 512 (128 registers) for the 3x3 tiles of C 384
#define IRK_GRAM_SHAPES(X) X(1, 2, 384) X(1, 3, 384) X(3, 2, 384) X(3, 3, 512)

struct GramTile {
  int h, mi0, nj0, mw, nw;  // head, first m16 / n8 tile, tiles in use
};

__host__ __device__ inline int gram_tiles(int heads, int ch, int MW,
                                          int NW8) {
  const int mh = (ch + 15) / 16;
  return heads * ((mh + MW - 1) / MW) * ((2 * mh + NW8 - 1) / NW8);
}

__device__ __forceinline__ GramTile gram_tile_of(int wi, int ch, int MW,
                                                 int NW8) {
  const int mh = (ch + 15) / 16, nm = (mh + MW - 1) / MW,
            nn = (2 * mh + NW8 - 1) / NW8;
  GramTile g;
  g.h = wi / (nm * nn);
  const int r = wi % (nm * nn);
  g.mi0 = (r / nn) * MW;
  g.nj0 = (r % nn) * NW8;
  g.mw = min(MW, mh - g.mi0);
  g.nw = min(NW8, 2 * mh - g.nj0);
  return g;
}

// acc += q_h^T k_h over 16 pixels from row p0 of qs and ks (pixel-major,
// row stride ldq, head h at column h chp): A (16 channels x 16 pixels) is
// q's stored 16 x 16 block transposed, B (16 pixels x 8 channels) k's, both
// by ldmatrix.trans
template <int MW, int NW8>
__device__ __forceinline__ void gram_step(float (&acc)[MW][NW8][4],
                                          const bf* qs, const bf* ks,
                                          int ldq, int p0, const GramTile& g,
                                          int chp, int lane) {
  const int c0 = g.h * chp;
  uint32_t a[MW][4];
  const bf* qrow = qs + (p0 + (lane & 7) + 8 * (lane >> 4)) * ldq + c0 +
                   8 * ((lane >> 3) & 1);
#pragma unroll
  for (int i = 0; i < MW; ++i)
    if (i < g.mw) ldmatrix_x4_trans(a[i], qrow + 16 * (g.mi0 + i));
  uint32_t b[NW8 + 1][2];
  const bf* krow = ks + (p0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * ldq +
                   c0 + 8 * (lane >> 4) + 8 * g.nj0;
#pragma unroll
  for (int j = 0; j < NW8; j += 2) {
    if (j + 1 < g.nw) {
      uint32_t r[4];
      ldmatrix_x4_trans(r, krow + 8 * j);
      b[j][0] = r[0];
      b[j][1] = r[1];
      b[j + 1][0] = r[2];
      b[j + 1][1] = r[3];
    } else if (j < g.nw) {
      ldmatrix_x2_trans(b[j], krow + 8 * j);
    }
  }
#pragma unroll
  for (int i = 0; i < MW; ++i)
#pragma unroll
    for (int j = 0; j < NW8; ++j)
      if (i < g.mw && j < g.nw) mma_bf16(acc[i][j], a[i], b[j][0], b[j][1]);
}

// a gram tile into gram (heads, ch, ch) float32, entries past ch dropped
template <int MW, int NW8>
__device__ __forceinline__ void gram_store(float* __restrict__ gram,
                                           const float (&acc)[MW][NW8][4],
                                           const GramTile& g, int ch,
                                           int lane) {
  float* dst = gram + static_cast<long long>(g.h) * ch * ch;
#pragma unroll
  for (int i = 0; i < MW; ++i)
#pragma unroll
    for (int j = 0; j < NW8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = 16 * (g.mi0 + i) + (lane >> 2) + 8 * (e >> 1);
        const int n = 8 * (g.nj0 + j) + 2 * (lane & 3) + (e & 1);
        if (i < g.mw && j < g.nw && m < ch && n < ch)
          dst[m * ch + n] = acc[i][j][e];
      }
}

template <int MW, int NW8>
__device__ __forceinline__ void zero_acc(float (&acc)[MW][NW8][4]) {
#pragma unroll
  for (int i = 0; i < MW; ++i)
#pragma unroll
    for (int j = 0; j < NW8; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
}

// qs / ks row stride: every head at chp columns, + 8 so that ldmatrix rows
// hit every bank once
__host__ __device__ inline int mdta_ldq(int C, int heads) {
  return heads * ((C / heads + 15) / 16 * 16) + 8;
}

template <int MW, int NW8, int NTH>
__global__ void __launch_bounds__(NTH, 1) mdta_mma_kernel(
    const bf* __restrict__ x, const float* __restrict__ ln_w,
    const float* __restrict__ ln_b, const uint2* __restrict__ w_qkv,
    const float* __restrict__ b_qkv, const float* __restrict__ w_dw,
    const float* __restrict__ b_dw, bf* __restrict__ v_out,
    float* __restrict__ part, int H, int W, int C, int NCH, int heads,
    int ln_mode, int TH, int TW, int NB, int GS) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nw = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int ntx = (W + TW - 1) / TW, nty = (H + TH - 1) / TH;
  const int ntiles = ntx * nty;
  const int gsl = blockIdx.x % GS, bi = blockIdx.x / GS;
  const long long b = bi / NB;
  const int ib = bi % NB;
  const int t0 = static_cast<int>(static_cast<long long>(ntiles) * ib / NB);
  const int t1 =
      static_cast<int>(static_cast<long long>(ntiles) * (ib + 1) / NB);
  const int cq = NCH * HC, ch = C / heads, chp = (ch + 15) & ~15;
  const int c16 = (C + 15) & ~15, ldx = c16 + 8, ldq = mdta_ldq(C, heads);
  const int hp = (TH + 2) * (TW + 2), hpr = (hp + 15) & ~15, tp = TH * TW;
  constexpr int LDU = 3 * HC + 8;
  float* ssq = reinterpret_cast<float*>(smem);  // [2][cq]
  float* red = ssq + 2 * cq;                    // [NW][2][HC]
  float* lnw = red + nw * 2 * HC;               // [2][C]: LN's weights
  bf* xs = reinterpret_cast<bf*>(lnw + 2 * C);
  bf* us = xs + hpr * ldx;
  bf* qs = us + hp * LDU;
  bf* ks = qs + tp * ldq;

  for (int e = threadIdx.x; e < 2 * cq; e += blockDim.x) ssq[e] = 0.f;
  // LN's weights from shared memory: L1 is what the shared memory leaves
  for (int e = threadIdx.x; e < C && ln_mode != 0; e += blockDim.x) {
    lnw[e] = ln_w[e];
    lnw[C + e] = ln_mode == 2 ? ln_b[e] : 0.f;
  }
  // the columns no chunk writes (past a head's width) stay 0
  for (int e = threadIdx.x; e < tp * ldq; e += blockDim.x)
    qs[e] = ks[e] = __float2bfloat16_rn(0.f);

  // this warp's gram tile (slice gsl holds tiles gsl NW ..)
  const int wi = gsl * nw + warp;
  const bool gram_on = wi < gram_tiles(heads, ch, MW, NW8);
  const GramTile gt = gram_tile_of(gram_on ? wi : 0, ch, MW, NW8);
  float acc[MW][NW8][4];
  zero_acc(acc);

  const int fr = frag_row(lane), fk = 8 * frag_khalf(lane);
  const int ks_in = c16 / 16, nq = TW / 4, segs2 = TH / 2 * nq;
  const int half = lane >> 4, cp = 2 * (lane & 15), hw = 2 * warp + half;
  const FastDiv f2(TW + 2), fw(TW), fseg(segs2), fnq(nq);
  const HaloCopy hc(x, C);
  auto tile_at = [&](int tile) {
    return FastTile(TH, TW, H, W, b, (tile / ntx) * TH, (tile % ntx) * TW,
                    f2, fw);
  };
  // chunk c's sums of squares from the warps' partials: four threads a
  // channel, each summing every fourth warp, then a fixed shuffle tree
  auto fold_ssq = [&](int c) {
    if (threadIdx.x < 8 * HC) {
      const int o = threadIdx.x >> 2, part = threadIdx.x & 3;
      const int which = o / HC, j = o % HC;
      float s = 0.f;
      for (int w2 = part; w2 < nw; w2 += 4) s += red[(w2 * 2 + which) * HC + j];
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (part == 0) ssq[which * cq + c * HC + j] += s;
    }
  };

  if (t0 < t1) stage_halo(x, xs, tile_at(t0), C, ldx, hpr, hc);
  for (int tile = t0; tile < t1; ++tile) {
    const FastTile t = tile_at(tile);
    cp_async_wait<0>();
    __syncthreads();
    if (ln_mode != 0) ln_in_place(xs, lnw, lnw + C, ln_mode, t, C, ldx, hpr);
    for (int ci = 0; ci < NCH; ++ci) {
      __syncthreads();  // xs staged / the previous chunk's taps read us
      if (ci > 0) fold_ssq(ci - 1);
      const uint2* wc = w_qkv + static_cast<long long>(ci) * ks_in * 12 * 32;
      const float* bc = b_qkv != nullptr ? b_qkv + ci * 3 * HC : nullptr;
      // (QT m16 tiles, q, k or v) tasks: at C 384 a task's 24 k steps wait
      // on weights from L2, so each fragment feeds several tiles (4 where
      // 384 threads leave the registers)
      constexpr int QT = NTH == 384 ? 4 : 2;
      const int nmt = hpr / 16;
      for (int task = warp; task < (nmt + QT - 1) / QT * 3; task += nw) {
        const int mp = task / 3, grp = task - 3 * mp, mt0 = QT * mp;
        const int nt = min(QT, nmt - mt0);
        float d[QT][4][4];
        mma_rows_x32<QT>(d, xs + (16 * mt0 + fr) * ldx + fk, ldx, nt, ks_in,
                         wc + grp * 4 * 32 + lane, 12);
#pragma unroll
        for (int i = 0; i < QT; ++i)
          if (i < nt) store_halo_u(us, LDU, grp * HC, bc, d[i], t, mt0 + i,
                                   lane);
      }
      __syncthreads();
      // xs is free after the last chunk's qkv: the next tile's copies
      // land during these taps and the gram
      if (ci == NCH - 1 && tile + 1 < t1)
        stage_halo(x, xs, tile_at(tile + 1), C, ldx, hpr, hc);
      // the taps: unit u = (group u / segs2, row pair and quad u % segs2)
      // to half-warp u % (2 NW)
      const int c = ci * HC + cp;  // this lane's channel pair
      const bool c_in = c < C;
      const int col = (c / ch) * chp + c % ch;  // its column in qs, ks
      float sq[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
      float wa[9], wb[9], ca = 0.f, cb = 0.f;
      int cur = -1;
      for (int u = hw; u < 3 * segs2; u += 2 * nw) {
        const int grp = fseg.div(u), seg = u - grp * segs2;
        if (grp != cur) {
          const int wcol = ci * 3 * HC + grp * HC + cp;
          load_taps(w_dw, NCH * 3 * HC, wcol, wa);
          load_taps(w_dw, NCH * 3 * HC, wcol + 1, wb);
          ca = b_dw ? b_dw[wcol] : 0.f;
          cb = b_dw ? b_dw[wcol + 1] : 0.f;
          cur = grp;
        }
        const int sr = fnq.div(seg), r = 2 * sr, q = 4 * (seg - sr * nq);
        float2 d[2][4];
        taps_2x4(us + (r * t.hw2 + q) * LDU + grp * HC + cp, t.hw2, LDU, wa,
                 wb, ca, cb, d);
        // output pixel (r + o, q + i) is canvas pixel (gy + o, gx + i)
        const int gy = t.y0 + r, gx = t.x0 + q;
#pragma unroll
        for (int o = 0; o < 2; ++o)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int p = (r + o) * TW + q + i;
            const bool in = gy + o < H && gx + i < W;
            if (grp == 2) {
              if (in && c_in && gsl == 0)
                *reinterpret_cast<uint32_t*>(
                    v_out + ((b * H + gy + o) * W + gx + i) * C + c) =
                    pack_bf16(d[o][i].x, d[o][i].y);
            } else if (c_in) {
              const float2 vv = in ? d[o][i] : make_float2(0.f, 0.f);
              *reinterpret_cast<uint32_t*>((grp ? ks : qs) + p * ldq + col) =
                  pack_bf16(vv.x, vv.y);
              sq[grp][0] = fmaf(vv.x, vv.x, sq[grp][0]);
              sq[grp][1] = fmaf(vv.y, vv.y, sq[grp][1]);
            }
          }
      }
      // both halves of the warp hold the same channel pairs
#pragma unroll
      for (int g2 = 0; g2 < 2; ++g2) {
        sq[g2][0] += __shfl_xor_sync(0xffffffffu, sq[g2][0], 16);
        sq[g2][1] += __shfl_xor_sync(0xffffffffu, sq[g2][1], 16);
        if (half == 0)
          *reinterpret_cast<float2*>(red + (warp * 2 + g2) * HC + cp) =
              make_float2(sq[g2][0], sq[g2][1]);
      }
    }
    __syncthreads();  // qs, ks and the sums complete
    fold_ssq(NCH - 1);
    if (gram_on)
      for (int kk = 0; kk < tp / 16; ++kk)
        gram_step(acc, qs, ks, ldq, 16 * kk, gt, chp, lane);
  }

  // one partial
  __syncthreads();  // the last chunk's sums folded
  const int gsz = heads * ch * ch;
  float* dst = part + static_cast<long long>(bi) * (gsz + 2 * cq);
  if (gram_on) gram_store(dst, acc, gt, ch, lane);
  if (gsl == 0)
    for (int e = threadIdx.x; e < 2 * cq; e += blockDim.x)
      dst[gsz + e] = ssq[e];
}

// shared bytes of mdta_mma_kernel: the sums of squares and their per-chunk
// partials, LN's weights, then the halo, u and q / k tiles
size_t mdta_mma_smem(int C, int heads, int TH, int TW, int nw) {
  const size_t cq = (C + HC - 1) / HC * HC, c16 = (C + 15) / 16 * 16;
  const size_t hp = static_cast<size_t>(TH + 2) * (TW + 2);
  const size_t hpr = (hp + 15) / 16 * 16, tp = static_cast<size_t>(TH) * TW;
  const size_t small =
      4 * (2 * cq + static_cast<size_t>(nw) * 2 * HC + 2 * C);
  return small + 2 * (hpr * (c16 + 8) + hp * (3 * HC + 8) +
                      2 * tp * mdta_ldq(C, heads));
}

// the gram of q and k (P pixels, pixel-major, bf16) through gram_step alone:
// one block stages both into the kernel's layout and each warp walks its
// MW x NW8 gram tiles in turn (the ldmatrix.trans path's own check)
template <int MW, int NW8>
__global__ void __launch_bounds__(128) gram_tile_kernel(
    const bf* __restrict__ q, const bf* __restrict__ k,
    float* __restrict__ gram, int P, int C, int heads) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ch = C / heads, chp = (ch + 15) & ~15, ldq = mdta_ldq(C, heads);
  bf* qs = reinterpret_cast<bf*>(smem);
  bf* ks = qs + P * ldq;
  for (int e = threadIdx.x; e < P * ldq; e += blockDim.x) {
    const int p = e / ldq, col = e % ldq, h = col / chp, c = col % chp;
    const bool in = h < heads && c < ch;
    qs[e] = in ? q[p * C + h * ch + c] : __float2bfloat16_rn(0.f);
    ks[e] = in ? k[p * C + h * ch + c] : __float2bfloat16_rn(0.f);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int wi = warp; wi < gram_tiles(heads, ch, MW, NW8);
       wi += blockDim.x >> 5) {
    const GramTile gt = gram_tile_of(wi, ch, MW, NW8);
    float acc[MW][NW8][4];
    zero_acc(acc);
    for (int kk = 0; kk < P / 16; ++kk)
      gram_step(acc, qs, ks, ldq, 16 * kk, gt, chp, lane);
    gram_store(gram, acc, gt, ch, lane);
  }
}

// shared bytes of each kernel at a tile
size_t gdfn_smem(int es, int C, int TH, int TW) {
  const int hpp = round4((TH + 2) * (TW + 2)), tp = TH * TW;
  return align16(static_cast<size_t>(es) * C * hpp) +
         sizeof(float) * (static_cast<size_t>(hpp) * 2 * HC +
                          round4(tp * (HC + 1)) +
                          static_cast<size_t>(tp) * round4(C));
}

size_t mdta_smem(int es, int C, int heads, int TH, int TW) {
  const int hpp = round4((TH + 2) * (TW + 2)), tp = TH * TW;
  const int cq = (C + HC - 1) / HC * HC, ch = C / heads;
  return align16(static_cast<size_t>(es) * C * hpp) +
         sizeof(float) * hpp * 3 * HC +
         2 * align16(static_cast<size_t>(es) * tp * cq) +
         sizeof(float) * (static_cast<size_t>(heads) * ch * ch + 2 * cq +
                          2 * NW * HC);
}

size_t smem_of(int kernel, int es, int C, int heads, int TH, int TW) {
  return kernel == 0 ? gdfn_smem(es, C, TH, TW)
                     : mdta_smem(es, C, heads, TH, TW);
}

constexpr int kTiles[4][2] = {{8, 16}, {8, 8}, {4, 8}, {4, 4}};
constexpr size_t kTwoPerSM = 113 * 1024;  // two blocks fit an SM's 228 KB
constexpr size_t kMaxSmem = 227 * 1024;

template <typename T>
int launch_gdfn(const void* x, const void* ln_w, const void* ln_b,
                const void* w_in, const void* b_in, const void* w_dw,
                const void* b_dw, const void* w_out, const void* b_out,
                void* out, int B, int H, int W, int C, int NCH, int ln_mode,
                int fast, int TH, int TW, int smem, void* stream) {
  if (TW % 4 || C % 4 ||
      static_cast<size_t>(smem) != gdfn_smem(sizeof(T), C, TH, TW))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = cudaFuncSetAttribute(
      gdfn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long nblk = static_cast<long long>(B) * ((H + TH - 1) / TH) *
                         ((W + TW - 1) / TW);
  gdfn_kernel<T><<<static_cast<unsigned>(nblk), NT, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(ln_w),
      static_cast<const float*>(ln_b), static_cast<const T*>(w_in),
      static_cast<const float*>(b_in), static_cast<const float*>(w_dw),
      static_cast<const float*>(b_dw), static_cast<const T*>(w_out),
      static_cast<const float*>(b_out), static_cast<T*>(out), H, W, C, NCH,
      ln_mode, fast, TH, TW);
  return static_cast<int>(cudaGetLastError());
}

// gram[b] and ssq[b] from the partials (mdta_reduce_kernel)
int launch_mdta_reduce(const void* part, void* gram, void* ssq, int B,
                       int NB, int C, int NCH, int heads, cudaStream_t st) {
  const int ch = C / heads, gs = heads * ch * ch;
  const long long total = static_cast<long long>(B) * (gs + 2 * C);
  mdta_reduce_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0,
                       st>>>(static_cast<const float*>(part),
                             static_cast<float*>(gram),
                             static_cast<float*>(ssq), NB, gs, NCH * HC, C,
                             total);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_mdta(const void* x, const void* ln_w, const void* ln_b,
                const void* w_qkv, const void* b_qkv, const void* w_dw,
                const void* b_dw, void* v, void* part, void* gram, void* ssq,
                int B, int H, int W, int C, int NCH, int heads, int ln_mode,
                int TH, int TW, int smem, int NB, void* stream) {
  if (TW % 4 || C % heads || (C / heads) % 4 || NB < 1 ||
      static_cast<size_t>(smem) != mdta_smem(sizeof(T), C, heads, TH, TW))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaFuncSetAttribute(
      mdta_front_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  mdta_front_kernel<T><<<static_cast<unsigned>(B * NB), NT, smem, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(ln_w),
      static_cast<const float*>(ln_b), static_cast<const T*>(w_qkv),
      static_cast<const float*>(b_qkv), static_cast<const float*>(w_dw),
      static_cast<const float*>(b_dw), static_cast<T*>(v),
      static_cast<float*>(part), H, W, C, NCH, heads, ln_mode, TH, TW, NB);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return launch_mdta_reduce(part, gram, ssq, B, NB, C, NCH, heads, st);
}

}  // namespace

// The tile a kernel (0: gdfn, 1: mdta) takes for C: the first of kTiles
// whose shared memory lets two blocks share an SM, else the first that
// fits at all. out = {TH, TW, shared bytes}; returns 1 if none fits.
extern "C" int restormer_plan(int kernel, int dt, int C, int heads,
                              int* out) {
  const int es = dt == kBF16 ? 2 : 4;
  const size_t limits[2] = {kTwoPerSM, kMaxSmem};
  for (const size_t limit : limits) {
    for (const auto& tile : kTiles) {
      const size_t s = smem_of(kernel, es, C, heads, tile[0], tile[1]);
      if (s <= limit) {
        out[0] = tile[0];
        out[1] = tile[1];
        out[2] = static_cast<int>(s);
        return 0;
      }
    }
  }
  return 1;
}

extern "C" int gdfn_block_f32(const void* x, const void* ln_w,
                              const void* ln_b, const void* w_in,
                              const void* b_in, const void* w_dw,
                              const void* b_dw, const void* w_out,
                              const void* b_out, void* out, int B, int H,
                              int W, int C, int NCH, int ln_mode, int fast,
                              int TH, int TW, int smem, void* stream) {
  return launch_gdfn<float>(x, ln_w, ln_b, w_in, b_in, w_dw, b_dw, w_out,
                            b_out, out, B, H, W, C, NCH, ln_mode, fast, TH,
                            TW, smem, stream);
}

// K4 in bf16: w_in and w_out are the packed fragment forms
// (ops/restormer_fused.py:gdfn_weights); the plan (gdfn_plan) is a TH x TW
// tile, `threads` threads, MT m16 tiles and NTW n8 tiles of project_out a
// warp, WN warps across the output columns and `smem` bytes.
extern "C" int gdfn_block_bf16(const void* x, const void* ln_w,
                               const void* ln_b, const void* w_in,
                               const void* b_in, const void* w_dw,
                               const void* b_dw, const void* w_out,
                               const void* b_out, void* out, int B, int H,
                               int W, int C, int NCH, int ln_mode, int fast,
                               int TH, int TW, int threads, int mt, int wn,
                               int smem, void* stream) {
  const int nw = threads / 32;
  const int ntw = mt == 2 ? 6 : 12;
  if (TW % 4 || TH % 2 || C % 4 || threads % 32 || threads > 512 ||
      nw % wn ||
      (mt != 1 && mt != 2) || TH * TW != 16 * mt * (nw / wn) ||
      8 * ntw * wn < C ||
      static_cast<size_t>(smem) != gdfn_mma_smem(C, TH, TW) ||
      static_cast<size_t>(smem) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long nblk = static_cast<long long>(B) * ((H + TH - 1) / TH) *
                         ((W + TW - 1) / TW);
  auto launch = [&](auto kernel) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<static_cast<unsigned>(nblk), threads, smem,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const float*>(ln_w), static_cast<const float*>(ln_b),
        static_cast<const uint2*>(w_in), static_cast<const float*>(b_in),
        static_cast<const float*>(w_dw), static_cast<const float*>(b_dw),
        static_cast<const uint2*>(w_out), static_cast<const float*>(b_out),
        static_cast<__nv_bfloat16*>(out), H, W, C, NCH, ln_mode, fast, TH,
        TW, wn);
    return static_cast<int>(cudaGetLastError());
  };
  return mt == 2 ? launch(gdfn_mma_kernel<2, 6>)
                 : launch(gdfn_mma_kernel<1, 12>);
}

extern "C" int mdta_front_f32(const void* x, const void* ln_w,
                              const void* ln_b, const void* w_qkv,
                              const void* b_qkv, const void* w_dw,
                              const void* b_dw, void* v, void* part,
                              void* gram, void* ssq, int B, int H, int W,
                              int C, int NCH, int heads, int ln_mode, int TH,
                              int TW, int smem, int NB, void* stream) {
  return launch_mdta<float>(x, ln_w, ln_b, w_qkv, b_qkv, w_dw, b_dw, v, part,
                            gram, ssq, B, H, W, C, NCH, heads, ln_mode, TH,
                            TW, smem, NB, stream);
}

// K5 in bf16: w_qkv is the packed fragment form (ops/restormer_fused.py:
// mdta_weights); the plan (mdta_plan) is a TH x TW tile, gram tiles of
// mw x nw8 (m16, n8) tiles and `threads` threads (an instantiated pair),
// GS gram slices and `smem` bytes; B NB GS blocks.
extern "C" int mdta_front_bf16(const void* x, const void* ln_w,
                               const void* ln_b, const void* w_qkv,
                               const void* b_qkv, const void* w_dw,
                               const void* b_dw, void* v, void* part,
                               void* gram, void* ssq, int B, int H, int W,
                               int C, int NCH, int heads, int ln_mode, int TH,
                               int TW, int threads, int mw, int nw8, int GS,
                               int smem, int NB, void* stream) {
  const int nw = threads / 32;
  if (C % 4 || C % heads || (C / heads) % 4 || NCH * HC < C || TW % 4 ||
      TH % 2 || (TH * TW) % 16 || GS < 1 || NB < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  // every slice holds some of the gram tiles, and they hold all
  const int wt = gram_tiles(heads, C / heads, mw, nw8);
  if (GS * nw < wt || (GS - 1) * nw >= wt ||
      static_cast<size_t>(smem) != mdta_mma_smem(C, heads, TH, TW, nw) ||
      static_cast<size_t>(smem) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto kernel) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<static_cast<unsigned>(B * NB * GS), threads, smem, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(ln_w),
        static_cast<const float*>(ln_b), static_cast<const uint2*>(w_qkv),
        static_cast<const float*>(b_qkv), static_cast<const float*>(w_dw),
        static_cast<const float*>(b_dw), static_cast<__nv_bfloat16*>(v),
        static_cast<float*>(part), H, W, C, NCH, heads, ln_mode, TH, TW, NB,
        GS);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    return launch_mdta_reduce(part, gram, ssq, B, NB, C, NCH, heads, st);
  };
  switch (mw * 10 + nw8) {
#define IRK_GRAM_CASE(m, n, t)                                           \
  case m * 10 + n:                                                       \
    return threads == t ? launch(mdta_mma_kernel<m, n, t>)               \
                        : static_cast<int>(cudaErrorInvalidValue);
    IRK_GRAM_SHAPES(IRK_GRAM_CASE)
#undef IRK_GRAM_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// gram (heads, C/heads, C/heads) float32 of q and k (P, C) bf16 through
// K5's gram step alone (gram_tile_kernel) at an instantiated MW x NW8 gram
// tile, P a multiple of 16
extern "C" int mdta_gram_tile(const void* q, const void* k, void* gram, int P,
                              int C, int heads, int mw, int nw8,
                              void* stream) {
  if (P < 16 || P % 16 || C % heads || (C / heads) % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 4 * static_cast<size_t>(P) * mdta_ldq(C, heads);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto launch = [&](auto kernel) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<1, 128, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k), static_cast<float*>(gram), P,
        C, heads);
    return static_cast<int>(cudaGetLastError());
  };
  switch (mw * 10 + nw8) {
#define IRK_GRAM_CASE(m, n, t) \
  case m * 10 + n:             \
    return launch(gram_tile_kernel<m, n>);
    IRK_GRAM_SHAPES(IRK_GRAM_CASE)
#undef IRK_GRAM_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
