// The Swin block's two kernels (replacing the TPU strip kernel
// image_restoration_agent_tpu/ops/pallas_attention.py:swin_strip_pallas,
// mlp_block_pallas, wmsa_block_pallas and, K2 alone, wmsa_pallas). See
// ops/swin_block.py for the blocks they make, what bounds them on the
// H100, and what is left for later work.
//
// K1 token_linear: out[o(t), :] = epi(pro(A[g(t), :]) @ W + bias)
//   - float32: one 64x64 output tile per block, K staged 32 at a time in
//     shared memory, 4x4 outputs per thread with FP32 FMA; bfloat16:
//     wgmma on the Hopper tensor cores (sm90_gemm.cuh), persistent
//     warp-specialised blocks, see the note above token_linear_mma_kernel;
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
#include "sm90_gemm.cuh"

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

// map_row in 32-bit arithmetic, for row counts below 2^31
__device__ __forceinline__ int map_row32(int t, int mode, const Geom& g) {
  if (mode == 0) return t;
  const int n = g.ws * g.ws;
  const int win = t / n;
  const int r = t - win * n;
  const int iy = r / g.ws, ix = r - iy * g.ws;
  const int nwx = g.W / g.ws, nwy = g.H / g.ws;
  const int wx = win % nwx;
  const int rest = win / nwx;
  const int wy = rest % nwy;
  const int b = rest / nwy;
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

// bf16 on Hopper: wgmma (sm90_gemm.cuh), persistent and warp-specialised.
//   - Block: four warpgroups, two producer-consumer pairs that take the
//     odd and the even tiles; about one block per SM (the launch plan's
//     grid), each with a fixed slice of NS
//     output columns (NS <= 192, an instantiated width: qkv 540 as 3 x 184,
//     fc1 360 as 2 x 184, proj 180 as 184), walking 64-row tiles t0, t0 +
//     step, ...
//   - The slice's weight stays in shared memory for the whole walk: one
//     1-D bulk copy of its kernel_matrix form (no-swizzle K-major core
//     matrices, K padded to 64 like A) at the start, counted on an
//     mbarrier. So
//     the weight is read once per block, not once per 64 rows. Where K x
//     NS and at least two A stages do not fit in 227 KB, the plan takes
//     narrower slices (fc2 at K 360: 2 x 96).
//   - A producer warpgroup gathers each tile's rows through the row map
//     (map_row32) into a ring of S stages (S even) in the
//     128-byte-swizzled K-major layout (K padded to 64, the pad zeroed
//     once), with the tile's output and residual row indices beside it:
//     bf16 rows by 8-byte cp.async a few tiles ahead, then normalized in
//     place where LayerNorm applies; float32 rows through registers. The
//     LayerNorm's float32 two-pass statistics are taken in registers, RP
//     rows a warp at a time, its scale and shift read from shared memory.
//     fence.proxy.async and an mbarrier arrive publish the stage
//     (full[s]).
//   - Consumer warpgroup c takes the tiles of parity c: wgmma m64nNSk16
//     with A and B both by descriptor, one instruction per k16 step, then
//     frees the stage (empty[s]) and runs the epilogue from its
//     accumulator registers while the other consumer multiplies: bias,
//     erf/tanh GELU, the residual read through r_map, one 4- or 8-byte
//     store of two columns through o_map.
constexpr int L_NT = 512;  // two producer + two consumer warpgroups
constexpr int L_TM = 64;   // rows per tile (one m64 accumulator)
constexpr int MAXK = 512;
// registers a thread after setmaxnreg, within the 512 x 128 the block was
// launched with (setmaxnreg.inc waits for registers the CTA does not
// have): 256 x 88 + 256 x 168 = 65536; a producer holds 32 floats of rows,
// a consumer an m64n184 accumulator (92)
constexpr int L_PRODUCER_REGS = 88;
constexpr int L_CONSUMER_REGS = 168;
static_assert(256 * L_PRODUCER_REGS + 256 * L_CONSUMER_REGS <= L_NT * 128,
              "register budget");

// shared memory of token_linear_mma_kernel: barriers (256 bytes) and the
// stages' row maps, the weight slice, the A stages; each 1024-aligned
__host__ __device__ constexpr size_t l_round(size_t v) {
  return (v + 1023) / 1024 * 1024;
}
// barriers, the stages' row maps, the slice's bias, the LayerNorm
// scale and shift
__host__ __device__ constexpr size_t l_head_bytes(int stages, int K,
                                                  int ns) {
  return l_round(256 + static_cast<size_t>(stages) * 3 * L_TM * 4 + 4 * ns +
                 8 * ((K + 63) / 64 * 64));
}
__host__ __device__ constexpr size_t l_w_bytes(int K, int ns) {
  return static_cast<size_t>((K + 63) / 64 * 64) * ns * 2;
}
__host__ __device__ constexpr size_t l_a_bytes(int K) {
  return static_cast<size_t>(L_TM) * ((K + 63) / 64 * 64) * 2;
}
constexpr size_t l_smem_bytes(int K, int ns, int stages) {
  return l_head_bytes(stages, K, ns) + l_round(l_w_bytes(K, ns)) +
         static_cast<size_t>(stages) * l_a_bytes(K);
}

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

__device__ __forceinline__ float gelu_f(float v, int gelu) {
  if (gelu == 1) return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
  if (gelu == 2)
    return 0.5f * v *
           (1.f + tanhf(0.7978845608f * (v + 0.044715f * v * v * v)));
  return v;
}

// barrier among the `count` threads (whole warps) that name barrier `id`
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// NR rows held by a warp (row r0 + q * rstep in v[q]; lane: k = 4 (lane +
// 32 j) .. + 3), the rows with on[q]: the optional LayerNorm (float32
// two-pass statistics, eps 1e-5, the rows' shuffles interleaved), rounded
// to bf16 and stored into an A stage
template <int KJ, int NR>
__device__ __forceinline__ void ln_store_rows(
    float4 (&v)[NR][KJ], const bool (&on)[NR], unsigned char* as, int r0,
    int rstep, int K, int k4, const float* __restrict__ ln_g,
    const float* __restrict__ ln_b, int lane) {
  float mu[NR], rs[NR];
#pragma unroll
  for (int q = 0; q < NR; ++q) {
    mu[q] = 0.f;
    rs[q] = 1.f;
  }
  if (ln_g != nullptr) {
#pragma unroll
    for (int q = 0; q < NR; ++q) {
      mu[q] = 0.f;
#pragma unroll
      for (int j = 0; j < KJ; ++j)
        mu[q] += v[q][j].x + v[q][j].y + v[q][j].z + v[q][j].w;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int q = 0; q < NR; ++q)
        mu[q] += __shfl_xor_sync(0xffffffffu, mu[q], o);
#pragma unroll
    for (int q = 0; q < NR; ++q) {
      mu[q] /= K;
      rs[q] = 0.f;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        if (lane + 32 * j >= k4) continue;
        const float a = v[q][j].x - mu[q], b = v[q][j].y - mu[q],
                    c = v[q][j].z - mu[q], d = v[q][j].w - mu[q];
        rs[q] += a * a + b * b + c * c + d * d;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int q = 0; q < NR; ++q)
        rs[q] += __shfl_xor_sync(0xffffffffu, rs[q], o);
#pragma unroll
    for (int q = 0; q < NR; ++q) rs[q] = rsqrtf(rs[q] / K + 1e-5f);
  }
#pragma unroll
  for (int q = 0; q < NR; ++q) {
    if (!on[q]) continue;
#pragma unroll
    for (int j = 0; j < KJ; ++j) {
      const int c = lane + 32 * j;
      if (c >= k4) continue;
      float e[4] = {v[q][j].x, v[q][j].y, v[q][j].z, v[q][j].w};
      if (ln_g != nullptr) {  // 16-byte aligned shared-memory copies
        const float4 gg = *reinterpret_cast<const float4*>(ln_g + 4 * c);
        const float4 bb = *reinterpret_cast<const float4*>(ln_b + 4 * c);
        e[0] = (e[0] - mu[q]) * rs[q] * gg.x + bb.x;
        e[1] = (e[1] - mu[q]) * rs[q] * gg.y + bb.y;
        e[2] = (e[2] - mu[q]) * rs[q] * gg.z + bb.z;
        e[3] = (e[3] - mu[q]) * rs[q] * gg.w + bb.w;
      }
      __nv_bfloat162 lo = __floats2bfloat162_rn(e[0], e[1]);
      __nv_bfloat162 hi = __floats2bfloat162_rn(e[2], e[3]);
      *reinterpret_cast<uint2*>(
          as + sw128_offset(r0 + q * rstep, 4 * c, L_TM)) =
          make_uint2(*reinterpret_cast<uint32_t*>(&lo),
                     *reinterpret_cast<uint32_t*>(&hi));
    }
  }
}

// Columns col .. col + 3 of one output row (b: their bias): bias, GELU,
// the residual, the store; one vector access each where N % 4 == 0 and
// all four lie inside N (rows 8- or 16-byte aligned then), else one
// element at a time.
__device__ __forceinline__ void epilogue4(float (&v)[4], const float* b,
                                          int col, int N, bool vec, int gelu,
                                          const void* R, int r_dt,
                                          long long rb, void* O, int o_dt,
                                          long long ob) {
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = gelu_f(v[i] + b[i], gelu);
  if (vec && col + 3 < N) {
    if (R != nullptr) {
      const float4 r = load4(R, rb + col, r_dt);
      v[0] += r.x;
      v[1] += r.y;
      v[2] += r.z;
      v[3] += r.w;
    }
    if (o_dt == kBF16) {
      __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
      __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
      *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(O) + ob + col) =
          make_uint2(*reinterpret_cast<uint32_t*>(&lo),
                     *reinterpret_cast<uint32_t*>(&hi));
    } else {
      *reinterpret_cast<float4*>(static_cast<float*>(O) + ob + col) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (col + i >= N) continue;
    if (R != nullptr) v[i] += load_any(R, rb + col + i, r_dt);
    store_any(O, ob + col + i, o_dt, v[i]);
  }
}

// KJ: float4 groups a lane holds of one row (K <= 128 KJ); RP rows a warp
// normalizes at once (RP / 2 loaded at once on the float32 path)
template <int NS, int KJ>
__global__ void __launch_bounds__(L_NT, 1) token_linear_mma_kernel(
    const void* __restrict__ A, int a_dt,
    const __nv_bfloat16* __restrict__ Wp, const float* __restrict__ bias,
    const void* __restrict__ R, int r_dt, void* __restrict__ O, int o_dt,
    const float* __restrict__ ln_g, const float* __restrict__ ln_b,
    long long M, int K, int N, int gelu, Geom g, int a_map, int r_map,
    int o_map, int nslices, int S) {
  constexpr int RP = 8 / KJ;
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* wbar = reinterpret_cast<uint64_t*>(smem);
  uint64_t* full = wbar + 1;
  uint64_t* empty = full + S;
  int* rows_s = reinterpret_cast<int*>(smem + 256);  // [S][3][L_TM]
  float* bias_s = reinterpret_cast<float*>(rows_s + S * 3 * L_TM);  // [NS]
  float* lng_s = bias_s + NS;  // [kpa] each, 0 past K
  float* lnb_s = lng_s + (K + 63) / 64 * 64;
  unsigned char* Ws = smem + l_head_bytes(S, K, NS);
  const uint32_t wbytes = static_cast<uint32_t>(l_w_bytes(K, NS));
  unsigned char* As = Ws + l_round(wbytes);
  const int abytes = static_cast<int>(l_a_bytes(K));
  const int kpa = (K + 63) / 64 * 64, kblocks = kpa / 64, k4 = K / 4;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // warpgroups 0 and 1 produce, 2 and 3 consume; pair p (producer p,
  // consumer p) takes the block's tiles of parity p, and with an even
  // stage count the stages of parity p, so the pairs never wait on each
  // other
  const int wgi = warp / 4;
  const int sl = static_cast<int>(blockIdx.x % nslices);
  const long long mtiles = (M + L_TM - 1) / L_TM;
  const long long t0 = blockIdx.x / nslices, tstep = gridDim.x / nslices;

  if (tid == 0) {
    mbar_init(wbar, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 128);
      mbar_init(&empty[s], 128);
    }
    fence_barrier_init();
  }
  for (int e = tid; e < NS; e += L_NT)
    bias_s[e] = sl * NS + e < N ? bias[sl * NS + e] : 0.f;
  if (ln_g != nullptr)
    for (int e = tid; e < kpa; e += L_NT) {
      lng_s[e] = e < K ? ln_g[e] : 0.f;
      lnb_s[e] = e < K ? ln_b[e] : 0.f;
    }
  const float* lg = ln_g != nullptr ? lng_s : nullptr;
  // the A stages' pad columns [K, kpa), zero for good (8-byte groups)
  const int per = (kpa - K) / 4;
  for (int e = tid; e < S * L_TM * per; e += L_NT) {
    const int s = e / (L_TM * per), r = (e / per) % L_TM;
    *reinterpret_cast<uint2*>(As + s * abytes +
                              sw128_offset(r, K + 4 * (e % per), L_TM)) =
        make_uint2(0u, 0u);
  }
  fence_proxy_async();
  __syncthreads();
  if (tid == 0) {
    mbar_arrive_expect_tx(wbar, wbytes);
    bulk_g2s(Ws, Wp + static_cast<long long>(sl) * (wbytes / 2), wbytes,
             wbar);
  }

  if (wgi < 2) {  // producers
    setmaxnreg_dec<L_PRODUCER_REGS>();
    const int pp = wgi, ptid = tid - 128 * pp, pw = warp % 4;
    const long long ntiles = t0 < mtiles ? (mtiles - t0 + tstep - 1) / tstep
                                         : 0;
    const int nown = ntiles > pp ? static_cast<int>((ntiles - pp + 1) / 2) : 0;
    // stage the k-th own tile's row maps: source rows (the producer's),
    // output and residual rows (the consumer's, published with the stage)
    auto maps = [&](int k) {
      const int it = 2 * k + pp, st = it % S;
      if (it >= S) mbar_wait(&empty[st], ((it / S) - 1) & 1);
      {  // threads 0-63 the source rows, 64-127 the output and residual
        const int r = ptid % L_TM;
        const long long t = (t0 + it * tstep) * L_TM + r;
        int* rw = rows_s + st * 3 * L_TM;
        const bool in = t < M;
        const int t32 = static_cast<int>(t);
        if (ptid < L_TM) {
          rw[r] = in ? map_row32(t32, a_map, g) : -1;
        } else {
          rw[L_TM + r] = in ? map_row32(t32, o_map, g) : -1;
          rw[2 * L_TM + r] = in && R != nullptr ? map_row32(t32, r_map, g)
                                                : 0;
        }
      }
      named_sync(1 + pp, 128);
    };
    if (a_dt == kBF16) {
      // bf16 rows: 8-byte cp.async straight into the stage (rows past M
      // zero-filled), LA own tiles in flight ahead of the one being
      // published; with ln_g the landed rows are normalized in place
      const int LA = S / 2 - 1 < 2 ? S / 2 - 1 : 2;
      const __nv_bfloat16* a16 = static_cast<const __nv_bfloat16*>(A);
      auto issue = [&](int k) {
        maps(k);
        const int st = (2 * k + pp) % S;
        unsigned char* as = As + st * abytes;
        const int* src = rows_s + st * 3 * L_TM;
        for (int r = pw; r < L_TM; r += 4) {
          const int s = src[r];
          for (int c = lane; c < k4; c += 32)
            cp_async8z(as + sw128_offset(r, 4 * c, L_TM),
                       s >= 0 ? a16 + static_cast<long long>(s) * K + 4 * c
                              : a16,
                       s >= 0 ? 8 : 0);
        }
      };
      for (int i = 0; i < LA; ++i) {  // LA groups, empty past the last tile
        if (i < nown) issue(i);
        cp_async_commit();
      }
      for (int k = 0; k < nown; ++k) {
        if (k + LA < nown) issue(k + LA);
        cp_async_commit();
        if (LA == 2)
          cp_async_wait<2>();
        else if (LA == 1)
          cp_async_wait<1>();
        else
          cp_async_wait<0>();
        // this thread's copies of the tile landed; it normalizes (with
        // ln_g) exactly the pieces it copied, and its arrival publishes
        const int st = (2 * k + pp) % S;
        unsigned char* as = As + st * abytes;
        if (lg != nullptr) {  // RP rows a warp at a time, 4 apart
          const int* src = rows_s + st * 3 * L_TM;
          for (int r0 = pw; r0 < L_TM; r0 += 4 * RP) {
            float4 v[RP][KJ];
            bool on[RP];
#pragma unroll
            for (int q = 0; q < RP; ++q) {
              on[q] = src[r0 + 4 * q] >= 0;
#pragma unroll
              for (int j = 0; j < KJ; ++j) {
                const int c = lane + 32 * j;
                v[q][j] = make_float4(0.f, 0.f, 0.f, 0.f);
                if (c < k4) {
                  const uint2 raw = *reinterpret_cast<const uint2*>(
                      as + sw128_offset(r0 + 4 * q, 4 * c, L_TM));
                  const float2 lo = __bfloat1622float2(
                      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
                  const float2 hi = __bfloat1622float2(
                      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
                  v[q][j] = make_float4(lo.x, lo.y, hi.x, hi.y);
                }
              }
            }
            ln_store_rows<KJ, RP>(v, on, as, r0, 4, K, k4, lg, lnb_s, lane);
          }
        }
        fence_proxy_async();
        mbar_arrive(&full[st]);
      }
    } else {
      // float32 rows through registers, converted (and normalized) into
      // the stage, RP / 2 rows a warp at a time, the next group's loads
      // issued before the current one is processed
      constexpr int RF = RP / 2;
      constexpr int NG = L_TM / (4 * RF);  // row groups a warp per tile
      for (int k = 0; k < nown; ++k) {
        maps(k);
        const int st = (2 * k + pp) % S;
        unsigned char* as = As + st * abytes;
        const int* src = rows_s + st * 3 * L_TM;
        float4 v[2][RF][KJ];
        auto load = [&](float4 (&u)[RF][KJ], int r0) {
#pragma unroll
          for (int q = 0; q < RF; ++q)
#pragma unroll
            for (int j = 0; j < KJ; ++j) {
              const int c = lane + 32 * j, s = src[r0 + q];
              u[q][j] = s >= 0 && c < k4
                            ? load4(A, static_cast<long long>(s) * K + 4 * c,
                                    a_dt)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
            }
        };
        load(v[0], pw * RF);
#pragma unroll
        for (int i = 0; i < NG; ++i) {
          const int r0 = (4 * i + pw) * RF;
          if (i + 1 < NG) load(v[(i + 1) & 1], r0 + 4 * RF);
          bool on[RF];
#pragma unroll
          for (int q = 0; q < RF; ++q) on[q] = src[r0 + q] >= 0;
          ln_store_rows<KJ, RF>(v[i & 1], on, as, r0, 1, K, k4, lg, lnb_s,
                                lane);
        }
        fence_proxy_async();
        mbar_arrive(&full[st]);
      }
    }
    return;
  }

  // consumers
  setmaxnreg_inc<L_CONSUMER_REGS>();
  const int ci = wgi - 2, wq = warp % 4;
  const int gq = lane >> 2, tq = lane & 3;
  const int n0 = sl * NS;
  mbar_wait(wbar, 0);
  float acc[NS / 2];
  int it = 0;
  for (long long tile = t0; tile < mtiles; tile += tstep, ++it) {
    if ((it & 1) != ci) continue;
    const int st = it % S;
    mbar_wait(&full[st], (it / S) & 1);
    const unsigned char* as = As + st * abytes;
    wgmma_fence();
    for (int kb = 0; kb < kblocks; ++kb) {  // 64 k a block, 4 k16 steps
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wgmma_ss<NS>(acc, a_desc_sw128(as + kb * (L_TM * 128) + j * 32),
                     b_desc(Ws + (4 * kb + j) * NS * 32, NS * 16),
                     kb > 0 || j > 0);
    }
    wgmma_commit();
    const int* rw = rows_s + st * 3 * L_TM + L_TM;
    const int r0 = wq * 16 + gq;
    const int orow[2] = {rw[r0], rw[r0 + 8]};
    const int rrow[2] = {rw[L_TM + r0], rw[L_TM + r0 + 8]};
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(&empty[st]);
    // Lanes t and t ^ 1 of a quad swap halves of column groups j and j + 1,
    // so each holds 4 consecutive columns: one 8-byte (bf16) or 16-byte
    // (f32) store, residual load and bias read instead of two.
    const bool odd = tq & 1;
    const bool vec = (N & 3) == 0;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (orow[half] < 0) continue;
      const long long ob = static_cast<long long>(orow[half]) * N;
      const long long rb = static_cast<long long>(rrow[half]) * N;
#pragma unroll
      for (int j = 0; j + 1 < NS / 8; j += 2) {
        const float x0 = acc[4 * j + 2 * half], x1 = acc[4 * j + 2 * half + 1];
        const float y0 = acc[4 * j + 4 + 2 * half],
                    y1 = acc[4 * j + 5 + 2 * half];
        const float s0 = __shfl_xor_sync(0xffffffffu, odd ? x0 : y0, 1);
        const float s1 = __shfl_xor_sync(0xffffffffu, odd ? x1 : y1, 1);
        float v[4] = {odd ? s0 : x0, odd ? s1 : x1, odd ? y0 : s0,
                      odd ? y1 : s1};
        const int cl = odd ? 8 * (j + 1) + 2 * (tq - 1) : 8 * j + 2 * tq;
        epilogue4(v, bias_s + cl, n0 + cl, N, vec, gelu, R, r_dt, rb, O,
                  o_dt, ob);
      }
      if constexpr ((NS / 8) % 2 == 1) {  // the last group alone
        constexpr int j = NS / 8 - 1;
        const int cl = 8 * j + 2 * tq;
        const int col = n0 + cl;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (col + i >= N) continue;
          float v = gelu_f(acc[4 * j + 2 * half + i] + bias_s[cl + i], gelu);
          if (R != nullptr) v += load_any(R, rb + col + i, r_dt);
          store_any(O, ob + col + i, o_dt, v);
        }
      }
    }
  }
}

// The GEMM core's own check (tests/test_torch_kernels.py): one warpgroup
// computes D (64 x NS, float32) = A (64 x K, bf16 row-major, K <= 64 a
// multiple of 16) x B (the first NS columns of a kernel_matrix form),
// with A staged in the 128-byte-swizzled layout and read by descriptor
// (rs 0) or by ldmatrix into registers (rs 1), B by bulk copy.
template <int NS>
__global__ void __launch_bounds__(128) gemm_tile_kernel(
    const __nv_bfloat16* __restrict__ A, const __nv_bfloat16* __restrict__ Bp,
    float* __restrict__ D, int K, int rs) {
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  unsigned char* As = smem + 1024;
  unsigned char* Bs = As + 64 * 64 * 2;
  const int tid = threadIdx.x, wq = tid / 32, lane = tid % 32;
  if (tid == 0) {
    mbar_init(bar, 1);
    fence_barrier_init();
  }
  for (int e = tid; e < 64 * 64; e += 128) {
    const int r = e / 64, k = e % 64;
    *reinterpret_cast<__nv_bfloat16*>(As + sw128_offset(r, k, 64)) =
        k < K ? A[r * K + k] : __float2bfloat16_rn(0.f);
  }
  fence_proxy_async();
  __syncthreads();
  const uint32_t bbytes = static_cast<uint32_t>(K) * NS * 2;
  if (tid == 0) {
    mbar_arrive_expect_tx(bar, bbytes);
    bulk_g2s(Bs, Bp, bbytes, bar);
  }
  mbar_wait(bar, 0);
  float acc[NS / 2];
  uint32_t a[4][4];
  if (rs) {
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      if (ks < K / 16)
        ldmatrix_x4(a[ks], As + sw128_offset(wq * 16 + frag_row(lane),
                                             ks * 16 + 8 * frag_khalf(lane),
                                             64));
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      if (ks < K / 16)
        wgmma_rs<NS>(acc, a[ks], b_desc(Bs + ks * NS * 32, NS * 16), ks > 0);
  } else {
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      if (ks < K / 16)
        wgmma_ss<NS>(acc, a_desc_sw128(As + ks * 32),
                     b_desc(Bs + ks * NS * 32, NS * 16), ks > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
  fence_regs(a);
  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int j = 0; j < NS / 8; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wq * 16 + gq + 8 * half, c = 8 * j + 2 * tq;
      D[r * NS + c] = acc[4 * j + 2 * half];
      D[r * NS + c + 1] = acc[4 * j + 2 * half + 1];
    }
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

// bf16: Wt is the packed form of ops/swin_block.py:kernel_matrix for a
// slice width `ns` (an instantiated width); `stages`, `smem` and `grid` are
// the wrapper's launch plan (token_linear_plan): the ring depth (even),
// the shared memory bytes (which must cover what the kernel lays out) and
// the number of persistent blocks (a multiple of the slice count). K % 4
// == 0, K <= 512, rows with 16-byte aligned starts, M and every mapped
// row < 2^31.
// float32: Wt is (K, N) row-major and the plan arguments are unused.
extern "C" int token_linear(const void* A, int a_dt, const void* Wt,
                            int w_dt, int ns, const void* bias,
                            const void* R, int r_dt, void* O, int o_dt,
                            const void* ln_g, const void* ln_b, long long M,
                            int K, int N, int gelu, int B, int H, int W,
                            int ws, int dc, int a_map, int r_map, int o_map,
                            int stages, int smem, int grid, void* stream) {
  const Geom g{B, H, W, ws, dc};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lg = static_cast<const float*>(ln_g);
  const float* lb = static_cast<const float*>(ln_b);
  const float* bf = static_cast<const float*>(bias);
  if (w_dt == kBF16) {
    const int nslices = (N + ns - 1) / ns;
    if (K % 4 != 0 || K > MAXK || stages < 2 || stages > 8 || stages % 2 ||
        grid % nslices != 0 ||
        static_cast<size_t>(smem) < l_smem_bytes(K, ns, stages))
      return cudaErrorInvalidValue;
    auto launch = [&](auto kernel) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return static_cast<int>(e);
      kernel<<<grid, L_NT, smem, s>>>(
          A, a_dt, static_cast<const __nv_bfloat16*>(Wt), bf, R, r_dt, O,
          o_dt, lg, lb, M, K, N, gelu, g, a_map, r_map, o_map, nslices,
          stages);
      return static_cast<int>(cudaGetLastError());
    };
    const bool narrow = K <= 256;
    switch (ns) {
#define IRK_CASE(n)                                      \
  case n:                                                \
    return narrow ? launch(token_linear_mma_kernel<n, 2>) \
                  : launch(token_linear_mma_kernel<n, 4>);
      IRK_GEMM_WIDTHS_192(IRK_CASE)
#undef IRK_CASE
      default:
        return cudaErrorInvalidValue;
    }
  }
  const long long tiles = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  const dim3 grid32(static_cast<unsigned>(tiles));
  token_linear_kernel<<<grid32, NT, 0, s>>>(
      A, a_dt, static_cast<const float*>(Wt), bf, R, r_dt, O, o_dt, lg, lb,
      M, K, N, gelu, g, a_map, r_map, o_map);
  return static_cast<int>(cudaGetLastError());
}

// D = A x B for one 64-row tile through the GEMM core (gemm_tile_kernel):
// A (64, K) bf16, K in {16, 32, 48, 64}; Bp the kernel_matrix form of a
// (K, ns) weight; rs 1 takes A from registers, 0 by descriptor.
extern "C" int gemm_tile(const void* A, const void* Bp, void* D, int K,
                         int ns, int rs, void* stream) {
  if (K % 16 != 0 || K < 16 || K > 64) return cudaErrorInvalidValue;
  const int smem = 1024 + 64 * 64 * 2 + 64 * ns * 2;
  auto launch = [&](auto kernel) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<1, 128, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(A),
        static_cast<const __nv_bfloat16*>(Bp), static_cast<float*>(D), K,
        rs);
    return static_cast<int>(cudaGetLastError());
  };
  switch (ns) {
#define IRK_CASE(n) \
  case n:           \
    return launch(gemm_tile_kernel<n>);
    IRK_GEMM_WIDTHS(IRK_CASE)
#undef IRK_CASE
    default:
      return cudaErrorInvalidValue;
  }
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
