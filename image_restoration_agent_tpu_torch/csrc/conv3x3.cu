// K3: SAME 3x3 convolution, stride 1, channels-last, replacing the TPU
// kernel image_restoration_agent_tpu/ops/conv3x3.py:conv3x3_pallas. See
// ops/conv3x3.py for what bounds it on the H100 and what is left for later.
//
// Implicit GEMM, no im2col in device memory. The folded roll is resolved
// in the halo's source addresses (modular indices); SAME zero padding lands
// at the rolled canvas's edges. With ln_pre, each halo pixel's LayerNorm
// statistics are computed first and the input is normalized (and rounded
// to the input dtype) while it is staged; the zero padding applies to the
// LN output. Bias, LeakyReLU and the residual are applied in float32
// before the one cast on store.
//   - float32 (conv3x3_kernel): a block owns TP output pixels of one row
//     and TN output channels, stages a 3 x (TP+2) halo and the 9 x chunk x
//     TN weight slab a chunk of input channels at a time, and sums 4x4
//     outputs per thread with FP32 FMA (no TF32).
//   - bfloat16 (conv3x3_mma_kernel): wgmma on the Hopper tensor cores, see
//     the note above the kernel.
//
// Plain C interface for ctypes; each entry returns cudaGetLastError().

#include "common.cuh"
#include "sm90_gemm.cuh"

using namespace irk;

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

// bf16 on Hopper: the implicit GEMM on wgmma (sm90_gemm.cuh), float32
// accumulators in registers.
//   - Tile: a block owns M_TH = 2 output rows x 64 pixels x one slice of NS
//     output channels (NS the padded Cout when Cout <= 256, else Cout split
//     into equal slices of at most 256); warpgroup g computes output row
//     y0 + g as one m64nNS accumulator.
//   - Halo: (M_TH + 2) x 66 pixels x 16 input channels a stage, staged
//     once for every output channel of the slice: the input is read 2x
//     (4 halo rows for 2 output rows) rather than 9x. The folded roll and
//     the SAME zero padding are in the per-pixel source indices (src_s).
//     The halo copies in with 8-byte cp.async (C 180 rows are 360 bytes
//     apart: 8-byte alignment is all there is), zero-filled past Cin and
//     off the canvas (through registers where Cin % 4 != 0); with ln_pre
//     each halo pixel's float32 two-pass statistics are computed once per
//     block, and each thread normalizes (and rounds to bf16) the halo
//     pieces it copied once they land, the next stage's while this one
//     multiplies; 0 off the canvas. A pixel's 32 bytes are stored with
//     its two 16-byte halves swapped where (p >> 2) & 1, so ldmatrix rows
//     hit every bank once.
//   - Products: tap (dy, dx) takes A from registers, ldmatrix.x4 of the
//     warp's 16 pixels starting at pixel 16 w + dx of halo row g + dy (a
//     descriptor could not start at an arbitrary pixel), and B (the tap's
//     16 x NS weights) from shared memory by descriptor: nine
//     m64nNSk16 wgmma per stage.
//   - Weights: conv3x3_weights packs them once per weight as
//     [slice][Cin chunk][tap][k half][NS/8][8][8] (the no-swizzle K-major
//     core matrices), so one 1-D bulk copy (no tensor map) brings a
//     stage's 9 x 16 x NS weights; its mbarrier counts the bytes.
//   - Pipeline: a ring of S stages (2-4, by shared memory). Stage c + S - 1
//     (weights by bulk copy from thread 0, halo by every thread) is issued
//     while stage c's wgmma run; one __syncthreads a stage frees the stage
//     the previous products read.
//   - Epilogue from the accumulator registers: bias, LeakyReLU, residual in
//     float32, then one bf16 pair store per two columns (single stores
//     where Cout is odd). No shared-memory round trip.
// Cin pads to 16 (one k16 step a stage), Cout to the first instantiated
// width (IRK_GEMM_WIDTHS) >= its slice: 3 -> 8, 12 -> 16, 24, 48, 60 -> 64,
// 180 -> 184, 768 -> 3 x 256.
constexpr int M_CT = 256;  // two warpgroups
constexpr int M_TH = 2;    // output rows per block, one per warpgroup
constexpr int M_HR = M_TH + 2;
constexpr int M_HP = TP + 2;
constexpr int M_NPIX = M_HR * M_HP;
constexpr int M_KC = 16;  // input channels per stage
constexpr int M_HALO_BYTES = M_NPIX * M_KC * 2;
// barriers (128), src_s, mean_s, rstd_s; then S halo and S weight stages
constexpr int M_FIXED = 128 + M_NPIX * 8 + 2 * M_NPIX * 4;
static_assert(M_FIXED % 128 == 0 && M_HALO_BYTES % 128 == 0, "alignment");

constexpr size_t mma_smem_bytes(int ns, int stages) {
  return M_FIXED + static_cast<size_t>(stages) *
                       (M_HALO_BYTES + 9 * ns * M_KC * 2);
}

// cp.async.wait_group with a run-time count of 0-2
__device__ __forceinline__ void cp_async_wait_n(int n) {
  if (n <= 0)
    cp_async_wait<0>();
  else if (n == 1)
    cp_async_wait<1>();
  else
    cp_async_wait<2>();
}

// LayerNorm statistics of every halo pixel over Cin (float32, two passes,
// eps 1e-5; 0 and 0 off the canvas), eight pixels a warp at a time with
// the channels in registers (8-byte loads where Cin % 4 == 0 and Cin <=
// 256), one pixel at a time otherwise
__device__ __forceinline__ void halo_ln_stats(
    const __nv_bfloat16* __restrict__ x, const long long* src_s,
    float* mean_s, float* rstd_s, int Cin) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if ((Cin & 3) == 0 && Cin <= 256) {
    constexpr int P = 8;
    const int c4 = Cin / 4;
    for (int e0 = warp * P; e0 < M_NPIX; e0 += P * (M_CT / 32)) {
      float4 v[P][2];
      float mu[P], rs[P];
#pragma unroll
      for (int q = 0; q < P; ++q) {
        const long long s = e0 + q < M_NPIX ? src_s[e0 + q] : -1;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = lane + 32 * j;
          v[q][j] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (s >= 0 && c < c4) {
            const uint2 raw = *reinterpret_cast<const uint2*>(x + s * Cin +
                                                              4 * c);
            const float2 lo = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
            const float2 hi = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
            v[q][j] = make_float4(lo.x, lo.y, hi.x, hi.y);
          }
        }
        mu[q] = v[q][0].x + v[q][0].y + v[q][0].z + v[q][0].w + v[q][1].x +
                v[q][1].y + v[q][1].z + v[q][1].w;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int q = 0; q < P; ++q)
          mu[q] += __shfl_xor_sync(0xffffffffu, mu[q], o);
#pragma unroll
      for (int q = 0; q < P; ++q) {
        mu[q] /= Cin;
        rs[q] = 0.f;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (lane + 32 * j >= c4) continue;
          const float a = v[q][j].x - mu[q], b = v[q][j].y - mu[q],
                      c = v[q][j].z - mu[q], d = v[q][j].w - mu[q];
          rs[q] += a * a + b * b + c * c + d * d;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int q = 0; q < P; ++q)
          rs[q] += __shfl_xor_sync(0xffffffffu, rs[q], o);
      if (lane < P && e0 + lane < M_NPIX) {
        float m = mu[0], r = rs[0];
#pragma unroll
        for (int q = 1; q < P; ++q)
          if (lane == q) {
            m = mu[q];
            r = rs[q];
          }
        const bool on = src_s[e0 + lane] >= 0;
        mean_s[e0 + lane] = on ? m : 0.f;
        rstd_s[e0 + lane] = on ? rsqrtf(r / Cin + 1e-5f) : 0.f;
      }
    }
    return;
  }
  for (int e = warp; e < M_NPIX; e += M_CT / 32) {
    const long long s = src_s[e];
    float mu = 0.f, rs = 0.f;
    if (s >= 0) {  // uniform across the warp
      const __nv_bfloat16* px = x + s * Cin;
      float a = 0.f;
      for (int c = lane; c < Cin; c += 32) a += __bfloat162float(px[c]);
      mu = warp_sum(a) / Cin;
      float d2 = 0.f;
      for (int c = lane; c < Cin; c += 32) {
        const float d = __bfloat162float(px[c]) - mu;
        d2 += d * d;
      }
      rs = rsqrtf(warp_sum(d2) / Cin + 1e-5f);
    }
    if (lane == 0) {
      mean_s[e] = mu;
      rstd_s[e] = rs;
    }
  }
}

template <int NS>
__global__ void __launch_bounds__(M_CT, 1) conv3x3_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wp,
    const float* __restrict__ bias, const __nv_bfloat16* __restrict__ res,
    const float* __restrict__ ln_g, const float* __restrict__ ln_b,
    __nv_bfloat16* __restrict__ out, int H, int W, int Cin, int Cout,
    int roll, int act, int nchunks, int nslices, int S) {
  constexpr int WSTAGE = 9 * NS * M_KC * 2;  // bytes of one weight stage
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  long long* src_s = reinterpret_cast<long long*>(smem + 128);
  float* mean_s = reinterpret_cast<float*>(smem + 128 + M_NPIX * 8);
  float* rstd_s = mean_s + M_NPIX;
  unsigned char* halo = smem + M_FIXED;
  unsigned char* wst = halo + S * M_HALO_BYTES;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wg = warp / 4, wq = warp % 4;
  const int nxb = (W + TP - 1) / TP, nyb = (H + M_TH - 1) / M_TH;
  long long bid = blockIdx.x;
  const int sl = static_cast<int>(bid % nslices);
  bid /= nslices;
  const int xb = static_cast<int>(bid % nxb);
  bid /= nxb;
  const int y0 = static_cast<int>(bid % nyb) * M_TH;
  const long long b = bid / nyb;
  const int x0 = xb * TP, n0 = sl * NS;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) mbar_init(&bars[s], 1);
    fence_barrier_init();
  }
  // halo pixel (r, p) sits at (y0 + r - 1, x0 + p - 1) of the rolled
  // canvas, whose pixel (i, j) is x[(i - roll) mod H, (j - roll) mod W]
  for (int e = tid; e < M_NPIX; e += M_CT) {
    const int r = e / M_HP, p = e % M_HP;
    const int ry = y0 + r - 1, rx = x0 + p - 1;
    long long s = -1;
    if (ry >= 0 && ry < H && rx >= 0 && rx < W)
      s = (b * H + pmod(ry - roll, H)) * W + pmod(rx - roll, W);
    src_s[e] = s;
  }
  __syncthreads();

  const __nv_bfloat16* wsl =
      wp + static_cast<long long>(sl) * nchunks * (WSTAGE / 2);
  auto load_w = [&](int c) {  // thread 0: stage c's weights
    const int st = c % S;
    mbar_arrive_expect_tx(&bars[st], WSTAGE);
    bulk_g2s(wst + st * WSTAGE, wsl + static_cast<long long>(c) * (WSTAGE / 2),
             WSTAGE, &bars[st]);
  };
  const int pre = S - 1 < nchunks ? S - 1 : nchunks;
  if (tid == 0)
    for (int c = 0; c < pre; ++c) load_w(c);

  if (ln_g != nullptr) {
    halo_ln_stats(x, src_s, mean_s, rstd_s, Cin);
    __syncthreads();
  }

  // stage c's halo: 16-byte halves (pixel e >> 1, channels 8 (e & 1) ..)
  auto stage_halo = [&](int c) {
    unsigned char* hs = halo + (c % S) * M_HALO_BYTES;
    for (int e = tid; e < 2 * M_NPIX; e += M_CT) {
      const int pe = e >> 1, h = e & 1, p = pe % M_HP;
      unsigned char* dst = hs + pe * 32 + ((h ^ ((p >> 2) & 1)) << 4);
      const long long s = src_s[pe];
      const int ch = c * M_KC + 8 * h;
      if ((Cin & 3) == 0) {
        const __nv_bfloat16* g = s >= 0 ? x + s * Cin + ch : x;
        cp_async8z(dst, g, s >= 0 && ch < Cin ? 8 : 0);
        cp_async8z(dst + 8, g + 4, s >= 0 && ch + 4 < Cin ? 8 : 0);
        continue;
      }
      float v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = 0.f;
      if (s >= 0) {
        const __nv_bfloat16* px = x + s * Cin;
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (ch + i < Cin) v[i] = __bfloat162float(px[ch + i]);
        if (ln_g != nullptr) {
          const float mu = mean_s[pe], rs = rstd_s[pe];
#pragma unroll
          for (int i = 0; i < 8; ++i)
            if (ch + i < Cin)
              v[i] = (v[i] - mu) * rs * ln_g[ch + i] + ln_b[ch + i];
        }
      }
      uint4 pk;
      uint32_t* pw = reinterpret_cast<uint32_t*>(&pk);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        __nv_bfloat162 t2 = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
        pw[i] = *reinterpret_cast<uint32_t*>(&t2);
      }
      *reinterpret_cast<uint4*>(dst) = pk;
    }
  };
  for (int c = 0; c < S - 1; ++c) {  // S - 1 groups, empty past the end
    if (c < nchunks) stage_halo(c);
    cp_async_commit();
  }
  // With ln_pre and Cin % 4 == 0 the halo lands raw; each thread then
  // normalizes the 16-byte halves it copied itself, so its own
  // cp.async.wait_group is all the ordering it needs (the next
  // __syncthreads publishes them). Off the canvas and past Cin the zeros
  // stay zero.
  const bool ln_in_place = ln_g != nullptr && (Cin & 3) == 0;
  auto normalize_halo = [&](int c) {
    unsigned char* hs = halo + (c % S) * M_HALO_BYTES;
    for (int e = tid; e < 2 * M_NPIX; e += M_CT) {
      const int pe = e >> 1, h = e & 1, p = pe % M_HP;
      const int ch = c * M_KC + 8 * h;
      if (src_s[pe] < 0 || ch >= Cin) continue;
      uint4* dst = reinterpret_cast<uint4*>(
          hs + pe * 32 + ((h ^ ((p >> 2) & 1)) << 4));
      uint4 pk = *dst;
      uint32_t* pw = reinterpret_cast<uint32_t*>(&pk);
      const float mu = mean_s[pe], rs = rstd_s[pe];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&pw[i]));
        const int k = ch + 2 * i;
        if (k < Cin) f.x = (f.x - mu) * rs * ln_g[k] + ln_b[k];
        if (k + 1 < Cin) f.y = (f.y - mu) * rs * ln_g[k + 1] + ln_b[k + 1];
        __nv_bfloat162 t2 = __floats2bfloat162_rn(f.x, f.y);
        pw[i] = *reinterpret_cast<uint32_t*>(&t2);
      }
      *dst = pk;
    }
  };
  if (ln_in_place) {
    cp_async_wait_n(S - 2);  // stage 0 (the S - 2 after it may fly)
    normalize_halo(0);
  }

  float acc[NS / 2];
  uint32_t a[9][4];
  for (int c = 0; c < nchunks; ++c) {
    const int st = c % S;
    // this thread's copies of stage c are done (S - 2 later ones may fly)
    cp_async_wait_n(S - 2);
    __syncthreads();  // stage c's halo visible; stage c - 1 free
    mbar_wait(&bars[st], (c / S) & 1);
    const unsigned char* hs = halo + st * M_HALO_BYTES;
    const unsigned char* ws = wst + st * WSTAGE;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int p = wq * 16 + frag_row(lane) + tap % 3;
      ldmatrix_x4(a[tap], hs + ((wg + tap / 3) * M_HP + p) * 32 +
                              ((frag_khalf(lane) ^ ((p >> 2) & 1)) << 4));
    }
    wgmma_fence();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap)
      wgmma_rs<NS>(acc, a[tap], b_desc(ws + tap * NS * M_KC * 2, NS * 16),
                   c > 0 || tap > 0);
    wgmma_commit();
    const int cn = c + S - 1;  // refill the stage chunk c - 1 used
    if (cn < nchunks) {
      if (tid == 0) load_w(cn);
      stage_halo(cn);
    }
    cp_async_commit();
    if (ln_in_place && c + 1 < nchunks) {  // stage c + 1, while c multiplies
      cp_async_wait_n(S - 2);
      normalize_halo(c + 1);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(a);
  }

  const int y = y0 + wg;
  if (y >= H) return;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int xo = x0 + wq * 16 + g + 8 * half;
    if (xo >= W) continue;
    const long long o = ((b * H + y) * W + xo) * Cout;
#pragma unroll
    for (int j = 0; j < NS / 8; ++j) {
      const int col = n0 + 8 * j + 2 * t;
      if (col >= Cout) continue;
      float v[2] = {acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]};
      const int nv = col + 1 < Cout ? 2 : 1;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (i >= nv) continue;
        if (bias != nullptr) v[i] += bias[col + i];
        if (act == 1)
          v[i] = v[i] >= 0.f ? v[i] : 0.01f * v[i];
        else if (act == 2)
          v[i] = v[i] >= 0.f ? v[i] : 0.2f * v[i];
        if (res != nullptr) v[i] += __bfloat162float(res[o + col + i]);
      }
      if (nv == 2 && (Cout & 1) == 0) {
        *reinterpret_cast<__nv_bfloat162*>(out + o + col) =
            __floats2bfloat162_rn(v[0], v[1]);
      } else {
        out[o + col] = __float2bfloat16_rn(v[0]);
        if (nv == 2) out[o + col + 1] = __float2bfloat16_rn(v[1]);
      }
    }
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

// bf16: `w` is the packed form of ops/conv3x3.py:conv3x3_weights for a
// slice width `ns` (an instantiated width), `stages` the ring depth and
// `smem` the shared-memory bytes of the wrapper's launch plan
// (conv3x3_plan), which must cover what the kernel lays out.
extern "C" int conv3x3_bf16(const void* x, const void* w, const void* bias,
                            const void* res, const void* ln_g,
                            const void* ln_b, void* out, int B, int H, int W,
                            int Cin, int Cout, int roll, int act, int ns,
                            int stages, int smem, void* stream) {
  if (stages < 2 || stages > 4 ||
      static_cast<size_t>(smem) < mma_smem_bytes(ns, stages))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nchunks = (Cin + M_KC - 1) / M_KC;
  const int nslices = (Cout + ns - 1) / ns;
  const long long nblk = static_cast<long long>(B) * ((H + M_TH - 1) / M_TH) *
                         ((W + TP - 1) / TP) * nslices;
  auto launch = [&](auto kernel) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<static_cast<unsigned>(nblk), M_CT, smem,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(bias),
        static_cast<const __nv_bfloat16*>(res),
        static_cast<const float*>(ln_g), static_cast<const float*>(ln_b),
        static_cast<__nv_bfloat16*>(out), H, W, Cin, Cout, roll, act,
        nchunks, nslices, stages);
    return static_cast<int>(cudaGetLastError());
  };
  switch (ns) {
#define IRK_CASE(n) \
  case n:           \
    return launch(conv3x3_mma_kernel<n>);
    IRK_GEMM_WIDTHS(IRK_CASE)
#undef IRK_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
