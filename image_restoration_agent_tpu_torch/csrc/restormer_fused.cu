// K4 gdfn_block and K5 mdta_front: Restormer's fused blocks, replacing the
// TPU kernels image_restoration_agent_tpu/ops/restormer_fused.py:
// gdfn_block_pallas and mdta_block_pallas (its front, _mdta_kernel). See
// ops/restormer_fused.py for the cast points, what bounds the kernels on the
// H100 and what is left for later.
//
// A block owns a TH x TW tile of output pixels. It stages LN(x) (or x) over
// the tile and its 1-pixel halo in shared memory once, channel-major and
// rounded to the input dtype. The hidden channels then go in chunks of HC:
// the weights are chunk-interleaved once per weight (ops/restormer_fused.py
// gdfn_weights / mdta_weights), so one product gives a chunk of every group
// (x1 and x2, or q, k and v) over the halo; its halo pixels outside the
// canvas are zeroed (the depthwise conv's SAME padding of the 1x1 output),
// the nine depthwise taps run from shared memory, and then
// - K4: the GELU gate (rounded to the input dtype) and a partial
//   project_out into a float32 accumulator in shared memory; the epilogue
//   adds the bias and the residual in float32 and casts once;
// - K5: v is written; q and k (rounded) are kept for the tile, their float32
//   sums of squares are summed per channel in a fixed order, and after the
//   last chunk the tile's per-head gram q^T k is added to the block's.
// A K5 block takes a fixed run of tiles of one sample and writes one
// partial; a second kernel sums the partials in block order (no atomics:
// the same bits every run).
//
// Products run on FP32 FMA in both dtypes, 4x4 outputs per thread.
//
// Plain C interface for ctypes; each entry returns cudaGetLastError().

#include "common.cuh"

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
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.y));
  return make_float4(a.x, a.y, b.x, b.y);
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
  const int ch = C / heads, gs = heads * ch * ch;
  const long long total = static_cast<long long>(B) * (gs + 2 * C);
  mdta_reduce_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0,
                       st>>>(static_cast<const float*>(part),
                             static_cast<float*>(gram),
                             static_cast<float*>(ssq), NB, gs, NCH * HC, C,
                             total);
  return static_cast<int>(cudaGetLastError());
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

extern "C" int gdfn_block_bf16(const void* x, const void* ln_w,
                               const void* ln_b, const void* w_in,
                               const void* b_in, const void* w_dw,
                               const void* b_dw, const void* w_out,
                               const void* b_out, void* out, int B, int H,
                               int W, int C, int NCH, int ln_mode, int fast,
                               int TH, int TW, int smem, void* stream) {
  return launch_gdfn<__nv_bfloat16>(x, ln_w, ln_b, w_in, b_in, w_dw, b_dw,
                                    w_out, b_out, out, B, H, W, C, NCH,
                                    ln_mode, fast, TH, TW, smem, stream);
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

extern "C" int mdta_front_bf16(const void* x, const void* ln_w,
                               const void* ln_b, const void* w_qkv,
                               const void* b_qkv, const void* w_dw,
                               const void* b_dw, void* v, void* part,
                               void* gram, void* ssq, int B, int H, int W,
                               int C, int NCH, int heads, int ln_mode, int TH,
                               int TW, int smem, int NB, void* stream) {
  return launch_mdta<__nv_bfloat16>(x, ln_w, ln_b, w_qkv, b_qkv, w_dw, b_dw,
                                    v, part, gram, ssq, B, H, W, C, NCH,
                                    heads, ln_mode, TH, TW, smem, NB, stream);
}
