// K4 gdfn_block and K5 mdta_front: Restormer's fused blocks, replacing the
// TPU kernels image_restoration_agent_tpu/ops/restormer_fused.py:
// gdfn_block_pallas and mdta_block_pallas (its front, _mdta_kernel). See
// ops/restormer_fused.py for the cast points, what bounds the kernels on the
// H100 and what is left for later.
//
// A block owns a TH x TW tile of output pixels. It stages LN(x) (or x) over
// the tile and its 1-pixel halo in shared memory once, in the input dtype.
// The hidden channels then go in chunks of HC: the weights are
// chunk-interleaved once per weight (ops/restormer_fused.py gdfn_weights /
// mdta_weights), so one product gives a chunk of every group (x1 and x2,
// or q, k and v) over the halo; its halo pixels outside the canvas are
// zeroed (the depthwise conv's SAME padding of the 1x1 output), the nine
// depthwise taps run from shared memory, and then
// - K4: the GELU gate (rounded to the input dtype) and a partial
//   project_out; the epilogue adds the bias and the residual in float32 and
//   casts once;
// - K5: v is written; q and k (in the input dtype) are kept for the tile,
//   their float32 sums of squares are summed per channel in a fixed order,
//   and after the last chunk the tile's per-head gram q^T k is added to
//   the block's.
// A K5 block takes a fixed run of tiles of one sample and writes one
// partial; a second kernel sums the partials in block order (no atomics:
// the same bits every run).
//
// Both kernels run their products on the tensor cores from pixel-major
// staging, on a tile chosen per C and dtype (ops/restormer_fused.py:
// gdfn_plan, mdta_plan): in bfloat16 on mma.sync m16n8k16
// (gdfn_mma_kernel, mdta_mma_kernel), in float32 in split TF32 on mma.sync
// m16n8k8 (gdfn_tf32_kernel, mdta_tf32_kernel: x = xh + xl split in
// registers, w = wh + wl from a form made once per weight, xl wh + xh wl
// + xh wh summed in float32). K4 keeps project_out's accumulators in
// registers across the chunks, K5 the per-head gram's across the block's
// run of tiles. The depthwise taps and the GELU gate run FP32 FMA.
//
// Plain C interface for ctypes; each entry returns cudaGetLastError().

#include "common.cuh"
#include "sm90_gemm.cuh"

using namespace irk;

namespace {

constexpr int HC = 32;  // hidden channels per chunk (ops/restormer_fused.py)

// four bf16 values (low half first) as floats
__device__ __forceinline__ float4 unpack4(const uint2 r) {
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.y));
  return make_float4(a.x, a.y, b.x, b.y);
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
  int TH, TW, hw2, hp, tp, H, W, y0, x0;
  long long b;
  __device__ Tile(int th, int tw, int h, int w, long long bb, int yy,
                  int xx)
      : TH(th), TW(tw), hw2(tw + 2), hp((th + 2) * (tw + 2)), tp(th * tw),
        H(h), W(w), y0(yy), x0(xx), b(bb) {}
};

// The kernels' tile: the divisions by TW + 2 and TW as multiply-shifts
// with dividers made once per kernel
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

__device__ __forceinline__ void load_taps(const float* w_dw, int ldw,
                                          int col, float (&w)[9]) {
#pragma unroll
  for (int s = 0; s < 9; ++s) w[s] = w_dw[s * ldw + col];
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
// column (bf16 or float32); halo rows r .. r + 3 feed output rows r (taps
// dy) and r + 1 (taps dy - 1), each summed in the order dy, dx, bias after
__device__ __forceinline__ float2 pair_f(const bf* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 pair_f(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

template <typename T>
__device__ __forceinline__ void taps_2x4(const T* base, int hw2, int ldu,
                                         const float (&wa)[9],
                                         const float (&wb)[9], float ca,
                                         float cb, float2 (&d)[2][4]) {
#pragma unroll
  for (int o = 0; o < 2; ++o)
#pragma unroll
    for (int i = 0; i < 4; ++i) d[o][i] = make_float2(0.f, 0.f);
#pragma unroll
  for (int dy = 0; dy < 4; ++dy) {
    const T* row = base + dy * hw2 * ldu;
    float2 av[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) av[k] = pair_f(row + k * ldu);
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

// ---------------------------------------------------------------------------
// The float32 kernels' shared pieces (K4 and K5 in float32): the bf16
// kernels' staging, 1x1 tasks and taps in float32, every product in split
// TF32 on mma.sync m16n8k8 (common.cuh: split_a, mma_tf32).
//
// x is staged over the halo pixel-major in float32: xs [hpr][ldx], ldx = C
// rounded up to 8, + 4 (ldx / 4 odd: the 16-byte rows an ldmatrix reads
// hit every bank once). A 16 x 8 A fragment of float32 rows comes by one
// ldmatrix.x4 (its b16 matrices' 32-bit words are the tf32 fragment's
// elements: lane l gives row frag_row(l) at k 4 frag_khalf(l)) and is split
// in registers (split_a: xh = rna(x) by integer ops, xl = x - xh, read by
// the tensor cores as its top 19 bits). B comes from a packed form made
// once per weight (ops/restormer_fused.py: tf32_frag_pack): per k8 step
// and n8 tile, lane 4g + t holds wh(k t, n g), wh(k t+4, n g), wl(k t, n
// g), wl(k t+4, n g) with wh = rna(w), wl = w - wh: one 16-byte load. Each
// k step adds xl wh, xh wl, xh wh in that order (mma_split_b). Nothing is
// rounded between the cast points: the 1x1 outputs, the taps, the gate, q
// and k stay float32.

// a global -> shared copy's width for rows of row_bytes from x: 16, or 8 /
// 4 where x or a row is not so aligned
__device__ __forceinline__ int copy_width(const void* x, int row_bytes) {
  const int a = static_cast<int>(reinterpret_cast<uintptr_t>(x)) | row_bytes;
  return a & 15 ? (a & 7 ? 4 : 8) : 16;
}

// how x's float32 rows are copied: w-byte pieces, segs a row, and the
// padded row's c8 / 4 quads to zero
struct HaloCopyF {
  int w, segs, q4;
  FastDiv fs, fq;
  __device__ HaloCopyF(const float* x, int C)
      : w(copy_width(x, 4 * C)), segs(4 * C / w), q4(((C + 7) & ~7) / 4),
        fs(segs), fq(q4) {}
};

// issue the copies of x's halo rows into xs (cp.async, one committed
// group) and zero what lies outside the canvas or past C
__device__ __forceinline__ void stage_halo_f32(const float* __restrict__ x,
                                               float* xs, const FastTile& t,
                                               int C, int ldx, int hpr,
                                               const HaloCopyF& hc) {
  const int we = hc.w / 4;
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
      *reinterpret_cast<uint4*>(xs + m * ldx + c) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// ln_in_place on a float32 halo: LP lanes a pixel, at most 6 float4 quads
// a lane read once into registers, float32 two-pass statistics, eps 1e-5,
// one write (C <= 768)
__device__ void ln_in_place_f32(float* xs, const float* ln_w,
                                const float* ln_b, int ln_mode,
                                const FastTile& t, int C, int ldx, int hpr) {
  constexpr int QMAX = 6;
  const int nq = C / 4;
  int lp = 1;
  while (lp * QMAX < nq) lp <<= 1;
  const int sub = threadIdx.x & (lp - 1), ppb = blockDim.x / lp;
  // every lane runs every pass: the statistics are summed by shuffles
  for (int m0 = 0; m0 < hpr; m0 += ppb) {
    const int m = m0 + threadIdx.x / lp;
    const bool ok = m < hpr && t.halo_in(m);
    float* row = xs + (ok ? m : 0) * ldx;
    float4 v[QMAX];
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < QMAX; ++k) {
      const int q = sub + lp * k;
      v[k] = ok && q < nq ? *reinterpret_cast<const float4*>(row + 4 * q)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
      s += (v[k].x + v[k].y) + (v[k].z + v[k].w);
    }
    for (int o = 1; o < lp; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    const float mu = s / C;
    float v2 = 0.f;
#pragma unroll
    for (int k = 0; k < QMAX; ++k) {
      if (sub + lp * k >= nq) continue;
      const float d0 = v[k].x - mu, d1 = v[k].y - mu, d2 = v[k].z - mu,
                  d3 = v[k].w - mu;
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
      const float4 f = v[k];
      const float4 w4 = reinterpret_cast<const float4*>(ln_w)[q];
      const float4 b4 = ln_mode == 2 ? reinterpret_cast<const float4*>(ln_b)[q]
                                     : make_float4(0.f, 0.f, 0.f, 0.f);
      float4 y;
      y.x = ln_mode == 2 ? (f.x - mu) * rs * w4.x + b4.x : f.x * rs * w4.x;
      y.y = ln_mode == 2 ? (f.y - mu) * rs * w4.y + b4.y : f.y * rs * w4.y;
      y.z = ln_mode == 2 ? (f.z - mu) * rs * w4.z + b4.z : f.z * rs * w4.z;
      y.w = ln_mode == 2 ? (f.w - mu) * rs * w4.w + b4.w : f.w * rs * w4.w;
      *reinterpret_cast<float4*>(row + 4 * q) = y;
    }
  }
}

// d += a b in split TF32, b's parts from the packed form (bh(k t), bh(k
// t+4), bl(k t), bl(k t+4)): al bh, ah bl, ah bh in that order
__device__ __forceinline__ void mma_split_b(float (&d)[4],
                                            const uint32_t (&ah)[4],
                                            const uint32_t (&al)[4],
                                            const uint4 b) {
  mma_tf32(d, al, b.x, b.y);
  mma_tf32(d, ah, b.z, b.w);
  mma_tf32(d, ah, b.x, b.y);
}

// an A fragment of a 16 x 8 float32 block by ldmatrix (row frag_row(lane),
// k 4 frag_khalf(lane) at p), split into TF32 parts
__device__ __forceinline__ void load_split_a(const float* p,
                                             uint32_t (&ah)[4],
                                             uint32_t (&al)[4]) {
  uint32_t a[4];
  ldmatrix_x4(a, p);
  split_a(__uint_as_float(a[0]), __uint_as_float(a[1]),
          __uint_as_float(a[2]), __uint_as_float(a[3]), ah, al);
}

// d = QT consecutive m16 tiles of halo rows (nt <= QT in use; A from arow +
// 16 i lda, this lane's row and k half) times NJ consecutive n8 tiles of a
// packed split weight (wb: this lane's fragment of k step 0's first tile,
// kstride the n8 tiles a k step): each B fragment feeds the QT tiles, each
// A fragment the NJ tiles
template <int QT, int NJ>
__device__ __forceinline__ void mma_rows_tf32(float (&d)[QT][NJ][4],
                                              const float* arow, int lda,
                                              int nt, int ks_n,
                                              const uint4* wb, int kstride) {
#pragma unroll
  for (int i = 0; i < QT; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      d[i][j][0] = d[i][j][1] = d[i][j][2] = d[i][j][3] = 0.f;
  // the next k step's fragments are in flight while this one's run
  uint4 bv[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) bv[j] = __ldg(wb + j * 32);
  for (int ks = 0; ks < ks_n; ++ks) {
    uint4 bn[NJ];
    if (ks + 1 < ks_n) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        bn[j] = __ldg(wb + ((ks + 1) * kstride + j) * 32);
    }
#pragma unroll
    for (int i = 0; i < QT; ++i) {
      if (i >= nt) break;
      uint32_t ah[4], al[4];
      load_split_a(arow + 16 * i * lda + 8 * ks, ah, al);
#pragma unroll
      for (int j = 0; j < NJ; ++j) mma_split_b(d[i][j], ah, al, bv[j]);
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) bv[j] = bn[j];
  }
}

// a 16 x 8 NJ product of halo m16 tile mt into the float32 u tile at
// columns col0 ..: + bias (from the chunk's first column, or none), 0 at
// pixels outside the canvas
template <int NJ>
__device__ __forceinline__ void store_halo_f32(float* us, int ldu, int col0,
                                               const float* __restrict__ bias,
                                               const float (&d)[NJ][4],
                                               const FastTile& t, int mt,
                                               int lane) {
  const int g = lane >> 2, t4 = lane & 3;
  bool keep[2], in[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int m = 16 * mt + g + 8 * r;
    keep[r] = m < t.hp;
    in[r] = t.halo_in(m);
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int col = col0 + 8 * j + 2 * t4;
    const float2 bi = bias != nullptr
                          ? *reinterpret_cast<const float2*>(bias + col)
                          : make_float2(0.f, 0.f);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (!keep[r]) continue;
      *reinterpret_cast<float2*>(us + (16 * mt + g + 8 * r) * ldu + col) =
          in[r] ? make_float2(d[j][2 * r] + bi.x, d[j][2 * r + 1] + bi.y)
                : make_float2(0.f, 0.f);
    }
  }
}

// A chunk's 1x1 over the halo (nmt m16 tiles of xs, the chunk's ngrp n8
// tiles of the packed weight wc) into us, as tasks of QT m16 tiles x NJ n8
// tiles over the block's warps: more m16 tiles a task reuse each B
// fragment more, fewer n8 tiles a task spread few m16 tiles over every
// warp (ops/restormer_fused.py: TF32_TASKS)
template <int QT, int NJ>
__device__ __forceinline__ void one_by_one_tf32(
    float* us, int ldu, const float* xs, int ldx, int nmt, int ngrp,
    int ks_n, const uint4* wc, const float* bias, const FastTile& t,
    int warp, int nw, int lane) {
  const int nmq = (nmt + QT - 1) / QT, nng = ngrp / NJ;
  const float* arow =
      xs + frag_row(lane) * ldx + 4 * frag_khalf(lane);
  for (int task = warp; task < nmq * nng; task += nw) {
    const int mq = task / nng, ng = task - mq * nng, mt0 = QT * mq;
    const int nt = min(QT, nmt - mt0);
    float d[QT][NJ][4];
    mma_rows_tf32<QT, NJ>(d, arow + 16 * mt0 * ldx, ldx, nt, ks_n,
                          wc + ng * NJ * 32 + lane, ngrp);
#pragma unroll
    for (int i = 0; i < QT; ++i)
      if (i < nt)
        store_halo_f32<NJ>(us, ldu, 8 * NJ * ng, bias, d[i], t, mt0 + i,
                           lane);
  }
}

// one_by_one_tf32 at the task shape code ts: 0 (2, 4), 1 (2, 2), 2 (1, 2)
// (QT, NJ)
__device__ __forceinline__ void one_by_one_tf32_at(
    int ts, float* us, int ldu, const float* xs, int ldx, int nmt, int ngrp,
    int ks_n, const uint4* wc, const float* bias, const FastTile& t,
    int warp, int nw, int lane) {
  if (ts == 0)
    one_by_one_tf32<2, 4>(us, ldu, xs, ldx, nmt, ngrp, ks_n, wc, bias, t,
                          warp, nw, lane);
  else if (ts == 1)
    one_by_one_tf32<2, 2>(us, ldu, xs, ldx, nmt, ngrp, ks_n, wc, bias, t,
                          warp, nw, lane);
  else
    one_by_one_tf32<1, 2>(us, ldu, xs, ldx, nmt, ngrp, ks_n, wc, bias, t,
                          warp, nw, lane);
}

// ---------------------------------------------------------------------------
// K4, float32: gdfn_mma_kernel's structure, both 1x1 products in split
// TF32 (mma.sync m16n8k8), the taps and the gate FP32 FMA.
//
// A block of NTH = 32 nw threads owns a TH x TW output tile (tp = 32 WM
// pixels, WM = nw / WN): xs [hpr][ldx] LN(x) over the halo
// (stage_halo_f32, ln_in_place_f32); per hidden chunk of HC, project_in
// as one_by_one_tf32 tasks (task shape TS) into us [hp][2 HC + 8] (float2
// fragment stores and the taps' row reads conflict-free), the taps and
// the erf (or tanh) gate, not rounded, into gs [tp][HC + 4]; project_out:
// warp w owns m16 rows 2 (w % WM), + 1 and n8 columns 3 (w / WM) .. of the
// (tp, 24 WN >= C) output. A chunk's four k steps accumulate in a second
// register set that is then added to the running sum in float32 (the
// tensor cores' adds drift about an ulp of the partial sum each: hid 1021
// at C 384 is 128 k steps), 2 x 24 floats a thread. Two barriers a chunk:
// project_out of chunk i and project_in of chunk i + 1 run in one phase
// (the taps of chunk i have read us, and gs is written again only after
// the next barrier). The epilogue adds b_out and the residual in float32.
constexpr int LDU4 = 2 * HC + 8;
constexpr int LDG4 = HC + 4;

__global__ void __launch_bounds__(512, 1) gdfn_tf32_kernel(
    const float* __restrict__ x, const float* __restrict__ ln_w,
    const float* __restrict__ ln_b, const uint4* __restrict__ w_in,
    const float* __restrict__ b_in, const float* __restrict__ w_dw,
    const float* __restrict__ b_dw, const uint4* __restrict__ w_out,
    const float* __restrict__ b_out, float* __restrict__ out, int H, int W,
    int C, int NCH, int ln_mode, int fast, int TH, int TW, int WN, int TS) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nw = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int ntx = (W + TW - 1) / TW, nty = (H + TH - 1) / TH;
  const int tx = blockIdx.x % ntx, ty = (blockIdx.x / ntx) % nty;
  const FastTile t(TH, TW, H, W, blockIdx.x / (ntx * nty), ty * TH, tx * TW,
                   FastDiv(TW + 2), FastDiv(TW));
  const int c8 = (C + 7) & ~7, ldx = c8 + 4, hpr = (t.hp + 15) & ~15;
  float* xs = reinterpret_cast<float*>(smem);
  float* us = xs + hpr * ldx;
  float* gs = us + t.hp * LDU4;

  stage_halo_f32(x, xs, t, C, ldx, hpr, HaloCopyF(x, C));
  cp_async_wait<0>();
  __syncthreads();
  if (ln_mode != 0) ln_in_place_f32(xs, ln_w, ln_b, ln_mode, t, C, ldx, hpr);

  const int wm = warp % (nw / WN), wn = warp / (nw / WN);
  const int ks_in = c8 / 8, nto = 3 * WN;
  float acc[2][3][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
  const int fr = frag_row(lane), fk = 4 * frag_khalf(lane);
  const int qs = TW / 4, segs2 = TH / 2 * qs;
  const FastDiv fqs(qs);
  // project_in of chunk ci: bias, ring zeroed, into us
  auto project_in = [&](int ci) {
    one_by_one_tf32_at(
        TS, us, LDU4, xs, ldx, hpr / 16, 8, ks_in,
        w_in + static_cast<long long>(ci) * ks_in * 8 * 32,
        b_in != nullptr ? b_in + ci * 2 * HC : nullptr, t, warp, nw, lane);
  };

  __syncthreads();  // xs normalized
  project_in(0);
  for (int ci = 0; ci < NCH; ++ci) {
    __syncthreads();  // us holds chunk ci's project_in
    // the taps and the gate as gdfn_mma_kernel's, in float32
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
        taps_2x4(us + (r * t.hw2 + q) * LDU4 + half * HC + cp, t.hw2, LDU4,
                 wa, wb, ca, cb, d);
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
                           (1.f + tanhf(0.7978845608028654f *
                                        (v + 0.044715f * v * v * v)))
                     : 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
            gv[k] = ge * (k ? x2.y : x2.x);
          }
          *reinterpret_cast<float2*>(gs + ((r + half) * TW + q + i) * LDG4 +
                                     cp) = make_float2(gv[0], gv[1]);
        }
      }
    }
    __syncthreads();  // gs complete; us free
    // project_out: the chunk's partial, then added in float32
    const uint4* wo = w_out + static_cast<long long>(ci) * 4 * nto * 32;
    float pa[2][3][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        pa[i][j][0] = pa[i][j][1] = pa[i][j][2] = pa[i][j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        load_split_a(gs + (32 * wm + 16 * i + fr) * LDG4 + 8 * ks + fk,
                     ah[i], al[i]);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const uint4 b = __ldg(wo + (ks * nto + 3 * wn + j) * 32 + lane);
#pragma unroll
        for (int i = 0; i < 2; ++i) mma_split_b(pa[i][j], ah[i], al[i], b);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += pa[i][j][e];
    if (ci + 1 < NCH) project_in(ci + 1);
  }

#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int col = 8 * (3 * wn + j) + 2 * t4;
    if (col >= C) continue;
    const float2 bo = b_out != nullptr
                          ? *reinterpret_cast<const float2*>(b_out + col)
                          : make_float2(0.f, 0.f);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int p = 32 * wm + 16 * i + g + 8 * r;
        if (p >= t.tp || !t.out_in(p)) continue;
        const long long o = t.out_pix(p) * C + col;
        const float2 xr = *reinterpret_cast<const float2*>(x + o);
        *reinterpret_cast<float2*>(out + o) =
            make_float2((acc[i][j][2 * r] + bo.x) + xr.x,
                        (acc[i][j][2 * r + 1] + bo.y) + xr.y);
      }
  }
}

size_t gdfn_tf32_smem(int C, int TH, int TW) {
  const size_t hp = static_cast<size_t>(TH + 2) * (TW + 2);
  const size_t hpr = (hp + 15) / 16 * 16, c8 = (C + 7) / 8 * 8;
  return 4 * (hpr * (c8 + 4) + hp * LDU4 +
              static_cast<size_t>(TH) * TW * LDG4);
}

// ---------------------------------------------------------------------------
// K5, float32: mdta_mma_kernel's structure, the qkv 1x1 and the per-head
// gram in split TF32 (mma.sync m16n8k8), the taps FP32 FMA, q, k and v
// float32.
//
// The qkv 1x1 runs as (m16 tile, q, k or v) tasks into us [hp][3 HC + 8];
// the taps write v to device memory and q and k into qs, ks [tp][ldq]
// (mdta_ldq: ldq % 32 is 8 or 24, so the gram's element-wise fragment
// loads hit every bank once). The gram's A = q_h^T and B = k_h come
// element by element from those pixel-major tiles (no ldmatrix.trans for
// 32-bit elements), split in registers. Warp w owns the gram tile of
// mdta_mma_kernel; its accumulators stay in registers across tiles and
// are added to the block's partial in device memory (in float32, each
// element by one lane, no atomics) every kGramFlushPx pixels and after
// the last tile: the tensor cores' adds drift about an ulp of the running
// sum each, and a block sums thousands of pixels.
constexpr int LDU5 = 3 * HC + 8;
constexpr int kGramFlushPx = 256;

// acc += q_h^T k_h over 8 pixels from row p0 of qs and ks (pixel-major,
// row stride ldq, head h at column h chp), split TF32: A (16 channels x 8
// pixels) is a0 = q[p0 + t][c + g], a1 = (c + g + 8), a2 = (p0 + t + 4),
// a3 = both; B (8 pixels x 8 channels) is b0 = k[p0 + t][c + g], b1 =
// k[p0 + t + 4][c + g]
template <int MW, int NW8>
__device__ __forceinline__ void gram_step_tf32(float (&acc)[MW][NW8][4],
                                               const float* qs,
                                               const float* ks, int ldq,
                                               int p0, const GramTile& g,
                                               int chp, int lane) {
  const int c0 = g.h * chp, gq = lane >> 2, tq = lane & 3;
  const float* qrow = qs + (p0 + tq) * ldq + c0 + gq;
  uint32_t ah[MW][4], al[MW][4];
#pragma unroll
  for (int i = 0; i < MW; ++i)
    if (i < g.mw) {
      const float* q = qrow + 16 * (g.mi0 + i);
      split_a(q[0], q[8], q[4 * ldq], q[4 * ldq + 8], ah[i], al[i]);
    }
  const float* krow = ks + (p0 + tq) * ldq + c0 + 8 * g.nj0 + gq;
#pragma unroll
  for (int j = 0; j < NW8; ++j) {
    if (j >= g.nw) continue;
    uint4 b;
    split1(krow[8 * j], b.x, b.z);
    split1(krow[8 * j + 4 * ldq], b.y, b.w);
#pragma unroll
    for (int i = 0; i < MW; ++i)
      if (i < g.mw) mma_split_b(acc[i][j], ah[i], al[i], b);
  }
}

// a gram tile added into gram (heads, ch, ch) float32 (written where
// first), entries past ch dropped, the accumulators zeroed
template <int MW, int NW8>
__device__ __forceinline__ void gram_add(float* __restrict__ gram,
                                         float (&acc)[MW][NW8][4],
                                         const GramTile& g, int ch, int lane,
                                         bool first) {
  float* dst = gram + static_cast<long long>(g.h) * ch * ch;
  // every earlier sum read before any store: the loads are in flight
  // together (a store between them would order them)
  float old[MW][NW8][4];
#pragma unroll
  for (int i = 0; i < MW; ++i)
#pragma unroll
    for (int j = 0; j < NW8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = 16 * (g.mi0 + i) + (lane >> 2) + 8 * (e >> 1);
        const int n = 8 * (g.nj0 + j) + 2 * (lane & 3) + (e & 1);
        old[i][j][e] = !first && i < g.mw && j < g.nw && m < ch && n < ch
                           ? dst[m * ch + n]
                           : 0.f;
      }
#pragma unroll
  for (int i = 0; i < MW; ++i)
#pragma unroll
    for (int j = 0; j < NW8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = 16 * (g.mi0 + i) + (lane >> 2) + 8 * (e >> 1);
        const int n = 8 * (g.nj0 + j) + 2 * (lane & 3) + (e & 1);
        if (i < g.mw && j < g.nw && m < ch && n < ch)
          dst[m * ch + n] = first ? acc[i][j][e] : old[i][j][e] + acc[i][j][e];
        acc[i][j][e] = 0.f;
      }
}

template <int MW, int NW8, int NTH>
__global__ void __launch_bounds__(NTH, 1) mdta_tf32_kernel(
    const float* __restrict__ x, const float* __restrict__ ln_w,
    const float* __restrict__ ln_b, const uint4* __restrict__ w_qkv,
    const float* __restrict__ b_qkv, const float* __restrict__ w_dw,
    const float* __restrict__ b_dw, float* __restrict__ v_out,
    float* __restrict__ part, int H, int W, int C, int NCH, int heads,
    int ln_mode, int TH, int TW, int NB, int GS, int TS) {
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
  const int c8 = (C + 7) & ~7, ldx = c8 + 4, ldq = mdta_ldq(C, heads);
  const int hp = (TH + 2) * (TW + 2), hpr = (hp + 15) & ~15, tp = TH * TW;
  float* ssq = reinterpret_cast<float*>(smem);  // [2][cq]
  float* red = ssq + 2 * cq;                    // [NW][2][HC]
  float* lnw = red + nw * 2 * HC;               // [2][C]: LN's weights
  float* xs = lnw + 2 * C;
  float* us = xs + hpr * ldx;
  float* qs = us + hp * LDU5;
  float* ks = qs + tp * ldq;

  for (int e = threadIdx.x; e < 2 * cq; e += blockDim.x) ssq[e] = 0.f;
  for (int e = threadIdx.x; e < C && ln_mode != 0; e += blockDim.x) {
    lnw[e] = ln_w[e];
    lnw[C + e] = ln_mode == 2 ? ln_b[e] : 0.f;
  }
  // the columns no chunk writes (past a head's width) stay 0
  for (int e = threadIdx.x; e < tp * ldq; e += blockDim.x) qs[e] = ks[e] = 0.f;

  const int wi = gsl * nw + warp;
  const bool gram_on = wi < gram_tiles(heads, ch, MW, NW8);
  const GramTile gt = gram_tile_of(gram_on ? wi : 0, ch, MW, NW8);
  float acc[MW][NW8][4];
  zero_acc(acc);
  const int gsz = heads * ch * ch;
  float* dst = part + static_cast<long long>(bi) * (gsz + 2 * cq);
  const int flush = max(1, kGramFlushPx / tp);

  const int ks_in = c8 / 8, nq = TW / 4, segs2 = TH / 2 * nq;
  const int half = lane >> 4, cp = 2 * (lane & 15), hw = 2 * warp + half;
  const FastDiv f2(TW + 2), fw(TW), fseg(segs2), fnq(nq);
  const HaloCopyF hc(x, C);
  auto tile_at = [&](int tile) {
    return FastTile(TH, TW, H, W, b, (tile / ntx) * TH, (tile % ntx) * TW,
                    f2, fw);
  };
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

  if (t0 < t1) stage_halo_f32(x, xs, tile_at(t0), C, ldx, hpr, hc);
  for (int tile = t0; tile < t1; ++tile) {
    const FastTile t = tile_at(tile);
    cp_async_wait<0>();
    __syncthreads();
    if (ln_mode != 0)
      ln_in_place_f32(xs, lnw, lnw + C, ln_mode, t, C, ldx, hpr);
    for (int ci = 0; ci < NCH; ++ci) {
      __syncthreads();  // xs staged / the previous chunk's taps read us
      if (ci > 0) fold_ssq(ci - 1);
      const uint4* wc = w_qkv + static_cast<long long>(ci) * ks_in * 12 * 32;
      const float* bc = b_qkv != nullptr ? b_qkv + ci * 3 * HC : nullptr;
      one_by_one_tf32_at(TS, us, LDU5, xs, ldx, hpr / 16, 12, ks_in, wc,
                         bc, t, warp, nw, lane);
      __syncthreads();
      if (ci == NCH - 1 && tile + 1 < t1)
        stage_halo_f32(x, xs, tile_at(tile + 1), C, ldx, hpr, hc);
      // the taps as mdta_mma_kernel's, q, k and v float32
      const int c = ci * HC + cp;
      const bool c_in = c < C;
      const int col = (c / ch) * chp + c % ch;
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
        taps_2x4(us + (r * t.hw2 + q) * LDU5 + grp * HC + cp, t.hw2, LDU5, wa,
                 wb, ca, cb, d);
        const int gy = t.y0 + r, gx = t.x0 + q;
#pragma unroll
        for (int o = 0; o < 2; ++o)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int p = (r + o) * TW + q + i;
            const bool in = gy + o < H && gx + i < W;
            if (grp == 2) {
              if (in && c_in && gsl == 0)
                *reinterpret_cast<float2*>(
                    v_out + ((b * H + gy + o) * W + gx + i) * C + c) =
                    d[o][i];
            } else if (c_in) {
              const float2 vv = in ? d[o][i] : make_float2(0.f, 0.f);
              *reinterpret_cast<float2*>((grp ? ks : qs) + p * ldq + col) =
                  vv;
              sq[grp][0] = fmaf(vv.x, vv.x, sq[grp][0]);
              sq[grp][1] = fmaf(vv.y, vv.y, sq[grp][1]);
            }
          }
      }
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
    if (gram_on) {
      for (int kk = 0; kk < tp / 8; ++kk)
        gram_step_tf32(acc, qs, ks, ldq, 8 * kk, gt, chp, lane);
      const int done = tile - t0 + 1;
      if (done % flush == 0 || tile + 1 == t1)
        gram_add(dst, acc, gt, ch, lane, done <= flush);
    }
  }

  __syncthreads();  // the last chunk's sums folded
  if (gsl == 0)
    for (int e = threadIdx.x; e < 2 * cq; e += blockDim.x)
      dst[gsz + e] = ssq[e];
}

// shared bytes of mdta_tf32_kernel: as mdta_mma_smem's, in float32
size_t mdta_tf32_smem(int C, int heads, int TH, int TW, int nw) {
  const size_t cq = (C + HC - 1) / HC * HC, c8 = (C + 7) / 8 * 8;
  const size_t hp = static_cast<size_t>(TH + 2) * (TW + 2);
  const size_t hpr = (hp + 15) / 16 * 16, tp = static_cast<size_t>(TH) * TW;
  return 4 * (2 * cq + static_cast<size_t>(nw) * 2 * HC + 2 * C +
              hpr * (c8 + 4) + hp * LDU5 + 2 * tp * mdta_ldq(C, heads));
}

constexpr size_t kMaxSmem = 227 * 1024;

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

}  // namespace

// K4 in float32: w_in and w_out are the packed split-TF32 forms
// (ops/restormer_fused.py: gdfn_weights); the plan (gdfn_plan) is a TH x TW
// tile of 32 * (threads / 32 / wn) pixels, wn warps across the 24 wn >= C
// output columns, project_in's task shape ts (one_by_one_tf32_at) and
// `smem` bytes.
extern "C" int gdfn_block_f32(const void* x, const void* ln_w,
                              const void* ln_b, const void* w_in,
                              const void* b_in, const void* w_dw,
                              const void* b_dw, const void* w_out,
                              const void* b_out, void* out, int B, int H,
                              int W, int C, int NCH, int ln_mode, int fast,
                              int TH, int TW, int threads, int wn, int ts,
                              int smem, void* stream) {
  const int nw = threads / 32;
  if (TW % 4 || TH % 2 || C % 4 || C > 768 || threads != 512 || wn < 1 ||
      ts < 0 || ts > 2 ||
      nw % wn || TH * TW != 32 * (nw / wn) || 24 * wn < C ||
      static_cast<size_t>(smem) != gdfn_tf32_smem(C, TH, TW) ||
      static_cast<size_t>(smem) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = cudaFuncSetAttribute(
      gdfn_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long nblk = static_cast<long long>(B) * ((H + TH - 1) / TH) *
                         ((W + TW - 1) / TW);
  gdfn_tf32_kernel<<<static_cast<unsigned>(nblk), threads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(ln_w),
      static_cast<const float*>(ln_b), static_cast<const uint4*>(w_in),
      static_cast<const float*>(b_in), static_cast<const float*>(w_dw),
      static_cast<const float*>(b_dw), static_cast<const uint4*>(w_out),
      static_cast<const float*>(b_out), static_cast<float*>(out), H, W, C,
      NCH, ln_mode, fast, TH, TW, wn, ts);
  return static_cast<int>(cudaGetLastError());
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

// K5 in float32: w_qkv is the packed split-TF32 form (ops/restormer_fused.py:
// mdta_weights); the plan (mdta_plan) as mdta_front_bf16's, and the qkv
// 1x1's task shape ts (one_by_one_tf32_at).
extern "C" int mdta_front_f32(const void* x, const void* ln_w,
                              const void* ln_b, const void* w_qkv,
                              const void* b_qkv, const void* w_dw,
                              const void* b_dw, void* v, void* part,
                              void* gram, void* ssq, int B, int H, int W,
                              int C, int NCH, int heads, int ln_mode, int TH,
                              int TW, int threads, int mw, int nw8, int GS,
                              int ts, int smem, int NB, void* stream) {
  const int nw = threads / 32;
  if (C % 4 || C > 768 || C % heads || (C / heads) % 4 || NCH * HC < C ||
      TW % 4 || TH % 2 || (TH * TW) % 8 || GS < 1 || NB < 1 || ts < 0 ||
      ts > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const int wt = gram_tiles(heads, C / heads, mw, nw8);
  if (GS * nw < wt || (GS - 1) * nw >= wt ||
      static_cast<size_t>(smem) != mdta_tf32_smem(C, heads, TH, TW, nw) ||
      static_cast<size_t>(smem) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto kernel) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<static_cast<unsigned>(B * NB * GS), threads, smem, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(ln_w),
        static_cast<const float*>(ln_b), static_cast<const uint4*>(w_qkv),
        static_cast<const float*>(b_qkv), static_cast<const float*>(w_dw),
        static_cast<const float*>(b_dw), static_cast<float*>(v),
        static_cast<float*>(part), H, W, C, NCH, heads, ln_mode, TH, TW, NB,
        GS, ts);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    return launch_mdta_reduce(part, gram, ssq, B, NB, C, NCH, heads, st);
  };
  switch (mw * 10 + nw8) {
#define IRK_GRAM_CASE(m, n, t)                                           \
  case m * 10 + n:                                                       \
    return threads == t ? launch(mdta_tf32_kernel<m, n, t>)              \
                        : static_cast<int>(cudaErrorInvalidValue);
    IRK_GRAM_SHAPES(IRK_GRAM_CASE)
#undef IRK_GRAM_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
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
