// K3: SAME 3x3 convolution, stride 1, channels-last, replacing the TPU
// kernel image_restoration_agent_tpu/ops/conv3x3.py:conv3x3_pallas. See
// ops/conv3x3.py for what bounds it on the H100 and what is left for later.
//
// Implicit GEMM, no im2col in device memory. A block owns TP output pixels
// of one row and TN output channels. It stages a 3 x (TP+2) halo of the
// input in shared memory, a chunk of input channels at a time, together
// with the 9 x chunk x TN weight slab, and accumulates in float32: 4x4
// outputs per thread with FP32 FMA in float32, WMMA bf16 fragments on the
// tensor cores in bfloat16. The folded roll is resolved in the halo's
// source addresses (modular indices); SAME zero padding lands at the
// rolled canvas's edges.
// With ln_pre, each halo pixel's LayerNorm statistics are computed first
// and the input is normalized (and rounded to the input dtype) while it is
// staged; the zero padding applies to the LN output. Bias, LeakyReLU and
// the residual are applied in float32 before the one cast on store.
//
// Plain C interface for ctypes; each entry returns cudaGetLastError().

#include <mma.h>

#include "common.cuh"

using namespace irk;
using namespace nvcuda;

namespace {

constexpr int TP = 64;   // output pixels per block (one row segment)
constexpr int TN = 64;   // output channels per block
constexpr int KC = 16;   // input channels per staged chunk
constexpr int CT = 256;  // threads per block
constexpr int HALO = TP + 2;
constexpr int NPIX = 3 * HALO;
constexpr int KP = KC + 1;  // padded pitch: conflict-free pixel-strided reads

// shared memory layout, in floats, each part 16-byte aligned
constexpr int round4(int v) { return (v + 3) / 4 * 4; }
constexpr int OFF_SRC = 0;                              // long long [NPIX]
constexpr int OFF_A = round4(2 * NPIX);                 // [3][HALO][KP]
constexpr int OFF_W = OFF_A + round4(NPIX * KP);        // [9][KC][TN]
constexpr int OFF_MEAN = OFF_W + 9 * KC * TN;           // [NPIX]
constexpr int OFF_RSTD = OFF_MEAN + round4(NPIX);       // [NPIX]
constexpr int SMEM_FLOATS = OFF_RSTD + round4(NPIX);
constexpr size_t SMEM_BYTES = SMEM_FLOATS * sizeof(float);

// Source pixel of every halo pixel, and with ln_pre its LayerNorm
// statistics. Halo pixel (r, p) sits at (y + r - 1, x0 + p - 1) of the
// rolled canvas, whose pixel (i, j) is x[(i - roll) mod H, (j - roll) mod
// W]; outside the canvas it is SAME padding (src -1). The caller syncs
// before reading the statistics.
template <typename T>
__device__ __forceinline__ void halo_setup(
    const T* __restrict__ x, long long* src_s, float* mean_s, float* rstd_s,
    const float* __restrict__ ln_g, long long b, int y, int x0, int H,
    int W, int Cin, int roll) {
  const int tid = threadIdx.x;
  for (int e = tid; e < NPIX; e += CT) {
    const int r = e / HALO, p = e % HALO;
    const int ry = y + r - 1, rx = x0 + p - 1;
    long long s = -1;
    if (ry >= 0 && ry < H && rx >= 0 && rx < W)
      s = (b * H + pmod(ry - roll, H)) * W + pmod(rx - roll, W);
    src_s[e] = s;
  }
  __syncthreads();
  if (ln_g == nullptr) return;
  const int warp = tid / 32, lane = tid % 32;
  for (int e = warp; e < NPIX; e += CT / 32) {
    const long long s = src_s[e];
    float mu = 0.f, rs = 0.f;
    if (s >= 0) {  // uniform across the warp
      const T* px = x + s * Cin;
      float a = 0.f;
      for (int c = lane; c < Cin; c += 32) a += to_f(px[c]);
      mu = warp_sum(a) / Cin;
      float v = 0.f;
      for (int c = lane; c < Cin; c += 32) {
        const float d = to_f(px[c]) - mu;
        v += d * d;
      }
      rs = rsqrtf(warp_sum(v) / Cin + 1e-5f);
    }
    if (lane == 0) {
      mean_s[e] = mu;
      rstd_s[e] = rs;
    }
  }
}

// float32: FP32 FMA, 4x4 outputs per thread
__global__ void __launch_bounds__(CT) conv3x3_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ bias, const float* __restrict__ res,
    const float* __restrict__ ln_g, const float* __restrict__ ln_b,
    float* __restrict__ out, int B, int H, int W, int Cin, int Cout,
    int roll, int act) {
  extern __shared__ __align__(16) float sm[];
  long long* src_s = reinterpret_cast<long long*>(sm + OFF_SRC);
  float* As = sm + OFF_A;
  float* Ws = sm + OFF_W;
  float* mean_s = sm + OFF_MEAN;
  float* rstd_s = sm + OFF_RSTD;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int nxb = (W + TP - 1) / TP, ncb = (Cout + TN - 1) / TN;
  long long bid = blockIdx.x;
  const int cb = static_cast<int>(bid % ncb);
  bid /= ncb;
  const int xb = static_cast<int>(bid % nxb);
  bid /= nxb;
  const int y = static_cast<int>(bid % H);
  const long long b = bid / H;
  const int x0 = xb * TP, n0 = cb * TN;

  halo_setup(x, src_s, mean_s, rstd_s, ln_g, b, y, x0, H, W, Cin, roll);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < Cin; c0 += KC) {
    __syncthreads();
    for (int e = tid; e < NPIX * KC; e += CT) {
      const int k = e % KC, rp = e / KC;
      const long long s = src_s[rp];
      float v = 0.f;
      if (s >= 0 && c0 + k < Cin) {
        v = x[s * Cin + c0 + k];
        if (ln_g != nullptr)
          v = (v - mean_s[rp]) * rstd_s[rp] * ln_g[c0 + k] + ln_b[c0 + k];
      }
      As[rp * KP + k] = v;
    }
    for (int e = tid; e < 9 * KC * TN; e += CT) {
      const int n = e % TN, k = (e / TN) % KC, tap = e / (TN * KC);
      float v = 0.f;
      if (c0 + k < Cin && n0 + n < Cout)
        v = w[(static_cast<long long>(tap) * Cin + c0 + k) * Cout + n0 + n];
      Ws[(tap * KC + k) * TN + n] = v;
    }
    __syncthreads();
    for (int dy = 0; dy < 3; ++dy) {
      for (int dx = 0; dx < 3; ++dx) {
        const float* Ar = As + (dy * HALO + dx) * KP;
        const float* Wr = Ws + (dy * 3 + dx) * KC * TN + ty * 4;
#pragma unroll
        for (int k = 0; k < KC; ++k) {
          const float4 wv = *reinterpret_cast<const float4*>(Wr + k * TN);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float a = Ar[(tx + 16 * i) * KP + k];
            acc[i][0] = fmaf(a, wv.x, acc[i][0]);
            acc[i][1] = fmaf(a, wv.y, acc[i][1]);
            acc[i][2] = fmaf(a, wv.z, acc[i][2]);
            acc[i][3] = fmaf(a, wv.w, acc[i][3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int xo = x0 + tx + 16 * i;
    if (xo >= W) continue;
    const long long o = ((b * H + y) * W + xo) * Cout;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + ty * 4 + j;
      if (n >= Cout) continue;
      float v = acc[i][j];
      if (bias != nullptr) v += bias[n];
      if (act == 1)
        v = v >= 0.f ? v : 0.01f * v;
      else if (act == 2)
        v = v >= 0.f ? v : 0.2f * v;
      if (res != nullptr) v += res[o + n];
      out[o + n] = v;
    }
  }
}

// bf16: the same staging, the products as WMMA 16x16x16 bf16 fragments
// with float32 accumulation. The wrapper passes the weight zero-padded to
// (3, 3, Cin rounded up to MKC, Cout rounded up to TN), so its slabs copy
// in 16-byte cp.async chunks. The halo is staged pixel-major with MKC
// channels per pixel row (64 bytes, so every pixel offset of a tap is a
// 32-byte aligned fragment pointer); 8 warps tile the 64x64 output 4
// (16 pixels) x 2 (32 channels); the accumulators go through shared memory
// so the epilogue stores whole pixel rows.
constexpr int MKC = 32;
constexpr int WLD = TN + 8;   // bf16 pitch of the weight slab
constexpr int CLD = TN + 4;   // float pitch of the accumulator tile
constexpr size_t align32(size_t v) { return (v + 31) / 32 * 32; }
constexpr size_t M_OFF_MEAN = NPIX * sizeof(long long);
constexpr size_t M_OFF_RSTD = M_OFF_MEAN + NPIX * sizeof(float);
constexpr size_t M_OFF_A = align32(M_OFF_RSTD + NPIX * sizeof(float));
constexpr size_t M_OFF_W = align32(M_OFF_A + NPIX * MKC * 2);
constexpr size_t M_OFF_C = align32(M_OFF_W + 9 * MKC * WLD * 2);
constexpr size_t M_SMEM_BYTES = M_OFF_C + TP * CLD * sizeof(float);

__global__ void __launch_bounds__(CT) conv3x3_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    const float* __restrict__ bias, const __nv_bfloat16* __restrict__ res,
    const float* __restrict__ ln_g, const float* __restrict__ ln_b,
    __nv_bfloat16* __restrict__ out, int B, int H, int W, int Cin, int Cout,
    int roll, int act) {
  extern __shared__ __align__(128) unsigned char smem[];
  long long* src_s = reinterpret_cast<long long*>(smem);
  float* mean_s = reinterpret_cast<float*>(smem + M_OFF_MEAN);
  float* rstd_s = reinterpret_cast<float*>(smem + M_OFF_RSTD);
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem + M_OFF_A);
  __nv_bfloat16* Ws = reinterpret_cast<__nv_bfloat16*>(smem + M_OFF_W);
  float* Cs = reinterpret_cast<float*>(smem + M_OFF_C);

  const int tid = threadIdx.x;
  const int nxb = (W + TP - 1) / TP, ncb = (Cout + TN - 1) / TN;
  long long bid = blockIdx.x;
  const int cb = static_cast<int>(bid % ncb);
  bid /= ncb;
  const int xb = static_cast<int>(bid % nxb);
  bid /= nxb;
  const int y = static_cast<int>(bid % H);
  const long long b = bid / H;
  const int x0 = xb * TP, n0 = cb * TN;
  const int cin_pad = (Cin + MKC - 1) / MKC * MKC;
  const int cout_pad = ncb * TN;

  halo_setup(x, src_s, mean_s, rstd_s, ln_g, b, y, x0, H, W, Cin, roll);

  const int warp = tid / 32, wm = warp % 4, wn = warp / 4;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);

  for (int c0 = 0; c0 < Cin; c0 += MKC) {
    __syncthreads();
    for (int e = tid; e < NPIX * MKC; e += CT) {
      const int k = e % MKC, rp = e / MKC;
      const long long s = src_s[rp];
      float v = 0.f;
      if (s >= 0 && c0 + k < Cin) {
        v = __bfloat162float(x[s * Cin + c0 + k]);
        if (ln_g != nullptr)
          v = (v - mean_s[rp]) * rstd_s[rp] * ln_g[c0 + k] + ln_b[c0 + k];
      }
      As[rp * MKC + k] = __float2bfloat16_rn(v);
    }
    // the weight slab: 9 taps x MKC rows x TN columns, 16-byte copies
    for (int e = tid; e < 9 * MKC * (TN / 8); e += CT) {
      const int ch = e % (TN / 8), k = (e / (TN / 8)) % MKC,
                tap = e / (MKC * (TN / 8));
      cp_async16(Ws + (tap * MKC + k) * WLD + ch * 8,
                 w + (static_cast<long long>(tap) * cin_pad + c0 + k) *
                         cout_pad + n0 + ch * 8);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
#pragma unroll
      for (int ks = 0; ks < MKC; ks += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major>
            af;
        wmma::load_matrix_sync(
            af, As + (dy * HALO + dx + wm * 16) * MKC + ks, MKC);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major>
              bf;
          wmma::load_matrix_sync(
              bf, Ws + (tap * MKC + ks) * WLD + wn * 32 + j * 16, WLD);
          wmma::mma_sync(acc[j], af, bf, acc[j]);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
    wmma::store_matrix_sync(Cs + wm * 16 * CLD + wn * 32 + j * 16, acc[j],
                            CLD, wmma::mem_row_major);
  __syncthreads();

  for (int e = tid; e < TP * TN; e += CT) {
    const int px = e / TN, n = e % TN;
    const int xo = x0 + px, co = n0 + n;
    if (xo >= W || co >= Cout) continue;
    const long long o = ((b * H + y) * W + xo) * Cout + co;
    float v = Cs[px * CLD + n];
    if (bias != nullptr) v += bias[co];
    if (act == 1)
      v = v >= 0.f ? v : 0.01f * v;
    else if (act == 2)
      v = v >= 0.f ? v : 0.2f * v;
    if (res != nullptr) v += __bfloat162float(res[o]);
    out[o] = __float2bfloat16_rn(v);
  }
}

}  // namespace

extern "C" int conv3x3_f32(const void* x, const void* w, const void* bias,
                           const void* res, const void* ln_g,
                           const void* ln_b, void* out, int B, int H, int W,
                           int Cin, int Cout, int roll, int act,
                           void* stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      conv3x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM_BYTES));
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long nblk = static_cast<long long>(B) * H *
                         ((W + TP - 1) / TP) * ((Cout + TN - 1) / TN);
  conv3x3_kernel<<<static_cast<unsigned>(nblk), CT, SMEM_BYTES,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<const float*>(res),
      static_cast<const float*>(ln_g), static_cast<const float*>(ln_b),
      static_cast<float*>(out), B, H, W, Cin, Cout, roll, act);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int conv3x3_bf16(const void* x, const void* w, const void* bias,
                            const void* res, const void* ln_g,
                            const void* ln_b, void* out, int B, int H, int W,
                            int Cin, int Cout, int roll, int act,
                            void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      conv3x3_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(M_SMEM_BYTES));
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long nblk = static_cast<long long>(B) * H *
                         ((W + TP - 1) / TP) * ((Cout + TN - 1) / TN);
  conv3x3_mma_kernel<<<static_cast<unsigned>(nblk), CT, M_SMEM_BYTES,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(bias),
      static_cast<const __nv_bfloat16*>(res),
      static_cast<const float*>(ln_g), static_cast<const float*>(ln_b),
      static_cast<__nv_bfloat16*>(out), B, H, W, Cin, Cout, roll, act);
  return static_cast<int>(cudaGetLastError());
}
