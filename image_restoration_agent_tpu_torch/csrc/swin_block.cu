// K1 of the Swin block (replacing, with K2 in csrc/window_attention.cu,
// the TPU strip kernel
// image_restoration_agent_tpu/ops/pallas_attention.py:swin_strip_pallas,
// mlp_block_pallas and wmsa_block_pallas). See ops/swin_block.py for the
// blocks they make, what bounds them on the H100, and what is left for
// later work.
//
// K1 token_linear: out[o(t), :] = epi(pro(A[g(t), :]) @ W + bias)
//   - float32: the split-TF32 product on the Hopper tensor cores
//     (sm90_gemm.cuh: split_tf32, wgmma_split), float32 accuracy at two or
//     three TF32 passes, any K, see the note above
//     token_linear_tf32_kernel; bfloat16: wgmma on the Hopper tensor cores
//     (sm90_gemm.cuh), persistent warp-specialised blocks, see the note
//     above token_linear_mma_kernel;
//   - prologue: optional LayerNorm of each row (float32 two-pass
//     statistics, eps 1e-5), the operand rounded to the weight dtype;
//     optional gather g of window-order token t from the rolled canvas;
//   - epilogue: bias, optional erf/tanh GELU, optional residual read
//     through its own row map, store through map o (scatter to the output
//     frame) in float32 or bfloat16.
//
// Plain C interface for ctypes; each entry returns cudaGetLastError().

#include <algorithm>
#include <type_traits>

#include "common.cuh"
#include "sm90_gemm.cuh"

using namespace irk;

namespace {

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
//   - K > 512 (RIDCP's fc2 at K 1024): a 64-row stage of whole rows no
//     longer fits beside the weight, so a tile is staged as K chunks of cb
//     64-k blocks (cb <= 8, one stage each, the last chunk ragged) and the
//     consumer walks them into one float32 accumulator, freeing each stage
//     as its products finish; the epilogue runs once, after the last
//     chunk. The producer zero-fills each chunk's columns past K. The
//     LayerNorm prologue needs whole rows and takes K <= 512 (cb covers
//     the row: one chunk, the layout above).
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
constexpr int MAXK = 2048;
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
// one A stage: 64 rows of a chunk of cb 64-k blocks
__host__ __device__ constexpr size_t l_a_bytes(int cb) {
  return static_cast<size_t>(L_TM) * 64 * cb * 2;
}
constexpr size_t l_smem_bytes(int K, int ns, int stages, int cb) {
  return l_head_bytes(stages, K, ns) + l_round(l_w_bytes(K, ns)) +
         static_cast<size_t>(stages) * l_a_bytes(cb);
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
// (columns from k4 to kz4, a chunk's pad past K, are stored as zeros)
template <int KJ, int NR>
__device__ __forceinline__ void ln_store_rows(
    float4 (&v)[NR][KJ], const bool (&on)[NR], unsigned char* as, int r0,
    int rstep, int K, int k4, int kz4, const float* __restrict__ ln_g,
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
      if (c >= kz4) continue;
      if (c >= k4) {
        *reinterpret_cast<uint2*>(
            as + sw128_offset(r0 + q * rstep, 4 * c, L_TM)) =
            make_uint2(0u, 0u);
        continue;
      }
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

// KJ: float4 groups a lane holds of one staged row (cb 64-k blocks <= 128
// KJ k); RP rows a warp normalizes at once (RP / 2 loaded at once on the
// float32 path); cb: 64-k blocks a chunk (all of them for whole rows)
template <int NS, int KJ>
__global__ void __launch_bounds__(L_NT, 1) token_linear_mma_kernel(
    const void* __restrict__ A, int a_dt,
    const __nv_bfloat16* __restrict__ Wp, const float* __restrict__ bias,
    const void* __restrict__ R, int r_dt, void* __restrict__ O, int o_dt,
    const float* __restrict__ ln_g, const float* __restrict__ ln_b,
    long long M, int K, int N, int gelu, Geom g, int a_map, int r_map,
    int o_map, int nslices, int S, int cb) {
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
  const int abytes = static_cast<int>(l_a_bytes(cb));
  const int kpa = (K + 63) / 64 * 64, kblocks = kpa / 64, k4 = K / 4;
  const int nch = (kblocks + cb - 1) / cb;  // K chunks a tile, 1: whole K

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
  // whole rows: the A stages' pad columns [K, kpa), zero for good (8-byte
  // groups); chunks: the producer zero-fills them with each chunk
  const int per = nch == 1 ? (kpa - K) / 4 : 0;
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
    // the q-th own staging is chunk q % nch of own tile q / nch, in stage
    // (2 q + pp) % S
    const int nstg = nown * nch;
    // stage the q-th staging's row maps: source rows (the producer's),
    // output and residual rows (the consumer's, published with the stage)
    auto maps = [&](int q) {
      const int it = 2 * q + pp, st = it % S;
      if (it >= S) mbar_wait(&empty[st], ((it / S) - 1) & 1);
      {  // threads 0-63 the source rows, 64-127 the output and residual
        const int r = ptid % L_TM;
        const long long t =
            (t0 + (2 * (q / nch) + pp) * tstep) * L_TM + r;
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
      auto issue = [&](int q) {
        maps(q);
        const int st = (2 * q + pp) % S;
        unsigned char* as = As + st * abytes;
        const int* src = rows_s + st * 3 * L_TM;
        // the chunk's first 4-k group, and the groups it writes: up to K
        // for whole rows, the whole chunk (zeros past K) for chunks
        const int c0 = (q % nch) * cb * 16;
        const int cn = nch == 1 ? k4 : min(cb * 16, kpa / 4 - c0);
        for (int r = pw; r < L_TM; r += 4) {
          const int s = src[r];
          for (int c = lane; c < cn; c += 32) {
            const bool in = s >= 0 && c0 + c < k4;
            cp_async8z(as + sw128_offset(r, 4 * c, L_TM),
                       in ? a16 + static_cast<long long>(s) * K +
                                4 * (c0 + c)
                          : a16,
                       in ? 8 : 0);
          }
        }
      };
      for (int i = 0; i < LA; ++i) {  // LA groups, empty past the last one
        if (i < nstg) issue(i);
        cp_async_commit();
      }
      for (int k = 0; k < nstg; ++k) {
        if (k + LA < nstg) issue(k + LA);
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
            ln_store_rows<KJ, RP>(v, on, as, r0, 4, K, k4, k4, lg, lnb_s,
                                  lane);
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
      for (int k = 0; k < nstg; ++k) {
        maps(k);
        const int st = (2 * k + pp) % S;
        unsigned char* as = As + st * abytes;
        const int* src = rows_s + st * 3 * L_TM;
        // the chunk's first 4-k group, its groups inside K, and the groups
        // it writes (zeros past K)
        const int c0 = (k % nch) * cb * 16;
        const int kl4 = min(k4 - c0, cb * 16);
        const int kz4 = nch == 1 ? kl4 : min(cb * 16, kpa / 4 - c0);
        float4 v[2][RF][KJ];
        auto load = [&](float4 (&u)[RF][KJ], int r0) {
#pragma unroll
          for (int q = 0; q < RF; ++q)
#pragma unroll
            for (int j = 0; j < KJ; ++j) {
              const int c = lane + 32 * j, s = src[r0 + q];
              u[q][j] = s >= 0 && c < kl4
                            ? load4(A,
                                    static_cast<long long>(s) * K +
                                        4 * (c0 + c),
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
          ln_store_rows<KJ, RF>(v[i & 1], on, as, r0, 1, K, kl4, kz4, lg,
                                lnb_s, lane);
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
  int it = 0, q = 0;  // the block's tiles, this consumer's stagings
  for (long long tile = t0; tile < mtiles; tile += tstep, ++it) {
    if ((it & 1) != ci) continue;
    // the tile's chunks before the last: multiply, then free the stage
    for (int ch = 0; ch + 1 < nch; ++ch, ++q) {
      const int sq = 2 * q + ci, st = sq % S;
      mbar_wait(&full[st], (sq / S) & 1);
      const unsigned char* as = As + st * abytes;
      wgmma_fence();
      for (int kb = 0; kb < cb; ++kb) {
        const int kg = ch * cb + kb;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wgmma_ss<NS>(acc, a_desc_sw128(as + kb * (L_TM * 128) + j * 32),
                       b_desc(Ws + (4 * kg + j) * NS * 32, NS * 16),
                       kg > 0 || j > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(&empty[st]);
    }
    const int sq = 2 * q + ci, st = sq % S;
    ++q;
    mbar_wait(&full[st], (sq / S) & 1);
    const unsigned char* as = As + st * abytes;
    const int kb0 = (nch - 1) * cb;  // the last chunk's first 64-k block
    wgmma_fence();
    for (int kb = 0; kb < kblocks - kb0; ++kb) {  // 4 k16 steps a block
      const int kg = kb0 + kb;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wgmma_ss<NS>(acc, a_desc_sw128(as + kb * (L_TM * 128) + j * 32),
                     b_desc(Ws + (4 * kg + j) * NS * 32, NS * 16),
                     kg > 0 || j > 0);
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

// float32 on Hopper: the split-TF32 core (sm90_gemm.cuh: split_tf32,
// wgmma_split) in K3's float32 ring (conv3x3.cu: conv3x3_tf32_kernel) rather
// than the bf16 kernel's persistent walk, whose weight slice stays in shared
// memory: split float32 weights (wh and wl, 8 bytes a value) leave room for
// a resident slice of 96 columns beside two A stages at K 180, 48 at K 360
// and 16 at K 1024.
//   - Block: four warpgroups, a tile of 256 rows (one m64 accumulator each)
//     x one slice of NS <= 96 output columns (the weight streamed through
//     shared memory is read once per 256 rows); a row tile's slices are
//     neighbours in the grid, so its rows come from L2 after the first.
//   - K in stages of 32 (any K: the last stage zero-filled past K), a ring
//     of S stages (2-6 by shared memory): each row gathered through the row
//     map into a 128-byte-swizzled K-major tile of 256 x 32 floats (16-byte
//     chunk c of row r at c ^ (r % 8)) by 16-byte cp.async (float32 rows,
//     K % 4 == 0, 16-byte aligned), through registers otherwise (bf16 rows,
//     widened exactly; a ragged K), and the stage's weights by one bulk
//     copy of the packed form (kernel_matrix: [slice][K/32][part][k
//     quad][NS/8][8][4]).
//   - LayerNorm at any K: token_ln_stats_kernel takes each row's float32
//     two-pass statistics once (not once per slice), and the consumer
//     normalizes its A fragments in registers after ldmatrix, before the
//     split (the scale and shift of its two k columns a k8 step).
//   - Products: per k8 step ldmatrix.x4 of the warp's 16 rows, split into
//     TF32 hi and lo in registers, 2 or 3 wgmma m64nNSk8 (xl wh, xh wl, xh
//     wh; xl is 0 for bf16 rows without LayerNorm, and skipped).
//   - Epilogue from the accumulators, the bf16 kernel's: bias, erf/tanh
//     GELU, the residual through r_map, 16- or 8-byte stores of four
//     columns through o_map.
// What bounds it: the tensor cores at 2-3 TF32 passes (3 x FLOP / 495
// TFLOP/s); at K 180 (SwinIR-M) a block runs 6 stages, so its set-up (row
// maps, the ring's fill) and its epilogue are a large share, and the
// streamed weights and rows (about 0.9 KB a row) ask L2 for about as many
// bytes a cycle as the products take.
constexpr int T_CT = 512;   // four warpgroups
constexpr int T_TM = 256;   // rows a block
constexpr int T_KC = 32;    // k a stage
// barriers (128), the row maps ([3][T_TM] long long), the slice's bias
// (128 floats); then S A and S weight stages
constexpr int T_FIXED = 7168;
constexpr int T_A_BYTES = T_TM * T_KC * 4;
static_assert(128 + 3 * T_TM * 8 + 128 * 4 <= T_FIXED, "fixed shared memory");

constexpr size_t t_smem_bytes(int ns, int parts, int stages) {
  return T_FIXED + static_cast<size_t>(stages) *
                       (T_A_BYTES + T_KC * ns * 4 * parts);
}

// LayerNorm statistics (mean, rstd) of each of A's M rows over K: float32
// two passes (the second from L1), eps 1e-5; one warp a row
__global__ void __launch_bounds__(256) token_ln_stats_kernel(
    const void* __restrict__ A, int a_dt, long long M, int K,
    float2* __restrict__ stats) {
  const int lane = threadIdx.x % 32;
  const long long nw = static_cast<long long>(gridDim.x) * 8;
  for (long long r = (blockIdx.x * 256LL + threadIdx.x) / 32; r < M;
       r += nw) {
    float s = 0.f;
    for (int k = lane; k < K; k += 32) s += load_any(A, r * K + k, a_dt);
    const float mu = warp_sum(s) / K;
    float v = 0.f;
    for (int k = lane; k < K; k += 32) {
      const float d = load_any(A, r * K + k, a_dt) - mu;
      v += d * d;
    }
    const float rs = rsqrtf(warp_sum(v) / K + 1e-5f);
    if (lane == 0) stats[r] = make_float2(mu, rs);
  }
}

template <int NS>
__global__ void __launch_bounds__(T_CT, 1) token_linear_tf32_kernel(
    const void* __restrict__ A, int a_dt, const float* __restrict__ Wp,
    const float* __restrict__ bias, const void* __restrict__ R, int r_dt,
    void* __restrict__ O, int o_dt, const float* __restrict__ ln_g,
    const float* __restrict__ ln_b, const float2* __restrict__ stats,
    long long M, int K, int N, int gelu, Geom g, int a_map, int r_map,
    int o_map, int nslices, int S, int parts, int vec) {
  const int wstage = T_KC * NS * 4 * parts;
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  long long* rows_s = reinterpret_cast<long long*>(smem + 128);  // [3][T_TM]
  float* bias_s = reinterpret_cast<float*>(rows_s + 3 * T_TM);  // [128]
  unsigned char* As = smem + T_FIXED;
  unsigned char* Wst = As + S * T_A_BYTES;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wg = warp / 4, wq = warp % 4;
  const int gq = lane >> 2, tq = lane & 3;
  const int sl = static_cast<int>(blockIdx.x % nslices);
  const long long m0 = static_cast<long long>(blockIdx.x / nslices) * T_TM;
  const int n0 = sl * NS;
  const int nk = (K + T_KC - 1) / T_KC;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) mbar_init(&bars[s], 1);
    fence_barrier_init();
  }
  for (int r = tid; r < T_TM; r += T_CT) {
    const long long t = m0 + r;
    const bool in = t < M;
    rows_s[r] = in ? map_row(t, a_map, g) : -1;
    rows_s[T_TM + r] = in ? map_row(t, o_map, g) : -1;
    rows_s[2 * T_TM + r] = in && R != nullptr ? map_row(t, r_map, g) : 0;
  }
  for (int e = tid; e < 128; e += T_CT)
    bias_s[e] = e < NS && n0 + e < N ? bias[n0 + e] : 0.f;
  __syncthreads();

  const float* wsl = Wp + static_cast<long long>(sl) * nk * (wstage / 4);
  auto load_w = [&](int j) {  // thread 0: stage j's weights
    const int st = j % S;
    mbar_arrive_expect_tx(&bars[st], wstage);
    bulk_g2s(Wst + st * wstage, wsl + static_cast<long long>(j) * (wstage / 4),
             wstage, &bars[st]);
  };
  const int pre = S - 1 < nk ? S - 1 : nk;
  if (tid == 0)
    for (int j = 0; j < pre; ++j) load_w(j);

  // stage j's A: 16-byte chunks (row e >> 3, k 32 j + 4 (e & 7) ..)
  auto stage_a = [&](int j) {
    unsigned char* as = As + (j % S) * T_A_BYTES;
    for (int e = tid; e < T_TM * 8; e += T_CT) {
      const int r = e >> 3, q = e & 7;
      unsigned char* dst = as + r * 128 + ((q ^ (r & 7)) << 4);
      const long long s = rows_s[r];
      const int k = j * T_KC + 4 * q;
      if (vec) {
        const bool in = s >= 0 && k < K;
        cp_async16z(dst, in ? static_cast<const float*>(A) + s * K + k : A,
                    in ? 16 : 0);
        continue;
      }
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (s >= 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (k + i < K) v[i] = load_any(A, s * K + k + i, a_dt);
      }
      *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    }
  };
  for (int j = 0; j < S - 1; ++j) {  // S - 1 groups, empty past the end
    if (j < nk) stage_a(j);
    cp_async_commit();
  }

  // this lane's ldmatrix row address of each k8 step of a stage, and with
  // LayerNorm its two rows' statistics (rows g and g + 8 of the fragment)
  uint32_t aoff[4];
  float mu[2] = {0.f, 0.f}, rs[2] = {0.f, 0.f};
  {
    const int r = 64 * wg + 16 * wq + frag_row(lane);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      aoff[ks] = r * 128 + (((2 * ks + frag_khalf(lane)) ^ (r & 7)) << 4);
    if (ln_g != nullptr)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long s = rows_s[64 * wg + 16 * wq + gq + 8 * h];
        if (s >= 0) {
          const float2 st = stats[s];
          mu[h] = st.x;
          rs[h] = st.y;
        }
      }
  }
  float acc[NS / 2];
  uint32_t hi[4][4], lo[4][4];
  const bool alo = a_dt != kBF16 || ln_g != nullptr;
  const bool wlo = parts == 2;
  for (int j = 0; j < nk; ++j) {
    const int st = j % S;
    // the LayerNorm scale and shift of this lane's k columns (t, t + 4 of
    // each k8 step), loaded before the barrier wait
    float lg[4][2], lb[4][2];
    if (ln_g != nullptr)
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int k = j * T_KC + 8 * ks + tq + 4 * h;
          lg[ks][h] = k < K ? __ldg(ln_g + k) : 0.f;
          lb[ks][h] = k < K ? __ldg(ln_b + k) : 0.f;
        }
    cp_async_wait_upto(S - 2);
    __syncthreads();  // stage j's rows visible; stage j - 1 free
    mbar_wait(&bars[st], (j / S) & 1);
    const unsigned char* as = As + st * T_A_BYTES;
    const unsigned char* wsg = Wst + st * wstage;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t raw[4];
      ldmatrix_x4(raw, as + aoff[ks]);
      if (ln_g != nullptr)  // raw[i]: row g + 8 (i & 1), k t + 4 (i >> 1)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          raw[i] = __float_as_uint(
              (__uint_as_float(raw[i]) - mu[i & 1]) * rs[i & 1] *
                  lg[ks][i >> 1] +
              lb[ks][i >> 1]);
      split_tf32(raw, hi[ks], lo[ks]);
    }
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_split<NS>(acc, hi[ks], lo[ks], b_desc(wsg + ks * NS * 32, NS * 16),
                      b_desc(wsg + (4 + ks) * NS * 32, NS * 16), alo, wlo,
                      j > 0 || ks > 0);
    wgmma_commit();
    const int jn = j + S - 1;  // refill the stage j - 1 used
    if (jn < nk) {
      if (tid == 0) load_w(jn);
      stage_a(jn);
    }
    cp_async_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(hi);
    fence_regs(lo);
  }

  // Lanes t and t ^ 1 of a quad swap halves of column groups j and j + 1,
  // so each holds 4 consecutive columns (as the bf16 kernel's epilogue)
  const bool odd = tq & 1;
  const bool vecn = (N & 3) == 0;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = 64 * wg + 16 * wq + gq + 8 * half;
    const long long orow = rows_s[T_TM + r];
    if (orow < 0) continue;
    const long long ob = orow * N;
    const long long rb = rows_s[2 * T_TM + r] * N;
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
      epilogue4(v, bias_s + cl, n0 + cl, N, vecn, gelu, R, r_dt, rb, O, o_dt,
                ob);
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

// The split-TF32 core's own check: one warpgroup computes D (64 x NS,
// float32) = A (64 x K, float32 row-major, K 8..32 a multiple of 8) x B
// (the first stage of a one-slice float32 kernel_matrix form, `parts` 1 or
// 2), A staged in token_linear_tf32_kernel's swizzled layout and read by
// ldmatrix, split in registers, B by bulk copy: the kernel's own product.
template <int NS>
__global__ void __launch_bounds__(128) gemm_tile_tf32_kernel(
    const float* __restrict__ A, const float* __restrict__ Bp,
    float* __restrict__ D, int K, int parts) {
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  unsigned char* As = smem + 1024;
  unsigned char* Bs = As + 64 * T_KC * 4;
  const int tid = threadIdx.x, wq = tid / 32, lane = tid % 32;
  if (tid == 0) {
    mbar_init(bar, 1);
    fence_barrier_init();
  }
  for (int e = tid; e < 64 * T_KC; e += 128) {
    const int r = e / T_KC, k = e % T_KC;
    *reinterpret_cast<float*>(As + r * 128 + (((k >> 2) ^ (r & 7)) << 4) +
                              (k & 3) * 4) = k < K ? A[r * K + k] : 0.f;
  }
  __syncthreads();
  const uint32_t bbytes = static_cast<uint32_t>(T_KC) * NS * 4 * parts;
  if (tid == 0) {
    mbar_arrive_expect_tx(bar, bbytes);
    bulk_g2s(Bs, Bp, bbytes, bar);
  }
  mbar_wait(bar, 0);
  float acc[NS / 2];
#pragma unroll
  for (int i = 0; i < NS / 2; ++i) acc[i] = 0.f;
  uint32_t hi[4][4], lo[4][4];
  const int r = wq * 16 + frag_row(lane);
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    uint32_t raw[4];
    ldmatrix_x4(raw, As + r * 128 +
                         (((2 * ks + frag_khalf(lane)) ^ (r & 7)) << 4));
    split_tf32(raw, hi[ks], lo[ks]);
  }
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    if (ks < K / 8)
      wgmma_split<NS>(acc, hi[ks], lo[ks], b_desc(Bs + ks * NS * 32, NS * 16),
                      b_desc(Bs + (4 + ks) * NS * 32, NS * 16), true,
                      parts == 2, 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
  fence_regs(hi);
  fence_regs(lo);
  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int j = 0; j < NS / 8; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int rr = wq * 16 + gq + 8 * half, c = 8 * j + 2 * tq;
      D[rr * NS + c] = acc[4 * j + 2 * half];
      D[rr * NS + c + 1] = acc[4 * j + 2 * half + 1];
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

}  // namespace

// bf16: Wt is the packed form of ops/swin_block.py:kernel_matrix for a
// slice width `ns` (an instantiated width); `stages`, `smem` and `grid` are
// the wrapper's launch plan (token_linear_plan): the ring depth (even),
// the shared memory bytes (which must cover what the kernel lays out) and
// the number of persistent blocks (a multiple of the slice count), and
// `cb` the 64-k blocks an A stage holds (all of K's for whole rows; fewer
// stages a tile's K in chunks, K > 512, no LayerNorm). K % 4 == 0,
// K <= 2048, rows with 16-byte aligned starts, M and every mapped row
// < 2^31.
// float32: Wt is the packed split-TF32 form of kernel_matrix (`parts` 1:
// wh alone, 2: wh and wl) for a slice width `ns` (an IRK_TF32_WIDTHS
// width <= 96), `stages` the ring depth (2-6), `smem` and `grid` the plan's
// (token_linear_f32_plan: one block per 256-row tile and slice), `vec` 1
// where rows may be staged 16 bytes at a time (float32 rows, K % 4 == 0,
// 16-byte aligned), `stats` an (M, 2) float32 workspace for the rows'
// LayerNorm statistics where ln_g is given (else nullptr); `cb` is unused.
// Any K and M.
extern "C" int token_linear(const void* A, int a_dt, const void* Wt,
                            int w_dt, int ns, const void* bias,
                            const void* R, int r_dt, void* O, int o_dt,
                            const void* ln_g, const void* ln_b, long long M,
                            int K, int N, int gelu, int B, int H, int W,
                            int ws, int dc, int a_map, int r_map, int o_map,
                            int stages, int cb, int smem, int grid, int parts,
                            int vec, void* stats, void* stream) {
  const Geom g{B, H, W, ws, dc};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lg = static_cast<const float*>(ln_g);
  const float* lb = static_cast<const float*>(ln_b);
  const float* bf = static_cast<const float*>(bias);
  if (w_dt == kBF16) {
    const int nslices = (N + ns - 1) / ns;
    const int kblocks = (K + 63) / 64;
    if (K % 4 != 0 || K > MAXK || stages < 2 || stages > 8 || stages % 2 ||
        grid % nslices != 0 || cb < 1 || cb > 8 ||
        (cb < kblocks && lg != nullptr) || (cb > kblocks) ||
        static_cast<size_t>(smem) < l_smem_bytes(K, ns, stages, cb))
      return cudaErrorInvalidValue;
    auto launch = [&](auto kernel) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return static_cast<int>(e);
      kernel<<<grid, L_NT, smem, s>>>(
          A, a_dt, static_cast<const __nv_bfloat16*>(Wt), bf, R, r_dt, O,
          o_dt, lg, lb, M, K, N, gelu, g, a_map, r_map, o_map, nslices,
          stages, cb);
      return static_cast<int>(cudaGetLastError());
    };
    const bool narrow = cb <= 4;  // a staged row of at most 256 k
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
  const int nslices = (N + ns - 1) / ns;
  if (parts < 1 || parts > 2 || stages < 2 || stages > 6 || K < 1 ||
      static_cast<size_t>(smem) < t_smem_bytes(ns, parts, stages) ||
      grid != ((M + T_TM - 1) / T_TM) * nslices ||
      (lg != nullptr) != (stats != nullptr))
    return cudaErrorInvalidValue;
  float2* st = static_cast<float2*>(stats);
  if (st != nullptr) {  // the rows' LayerNorm statistics, once
    long long blocks = (M + 7) / 8;
    if (blocks > 132 * 32) blocks = 132 * 32;
    token_ln_stats_kernel<<<static_cast<unsigned>(blocks), 256, 0, s>>>(
        A, a_dt, M, K, st);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  auto launch = [&](auto kernel) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<grid, T_CT, smem, s>>>(A, a_dt, static_cast<const float*>(Wt),
                                    bf, R, r_dt, O, o_dt, lg, lb, st, M, K,
                                    N, gelu, g, a_map, r_map, o_map, nslices,
                                    stages, parts, vec);
    return static_cast<int>(cudaGetLastError());
  };
  switch (ns) {
#define IRK_CASE(n) \
  case n:           \
    return launch(token_linear_tf32_kernel<n>);
    IRK_TF32_WIDTHS_96(IRK_CASE)
#undef IRK_CASE
    default:
      return cudaErrorInvalidValue;
  }
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

// D = A x B for one 64-row tile through the split-TF32 core
// (gemm_tile_tf32_kernel): A (64, K) float32, K in {8, 16, 24, 32}; Bp a
// one-slice float32 kernel_matrix form of a (K, ns) weight with `parts`
// parts.
extern "C" int gemm_tile_tf32(const void* A, const void* Bp, void* D, int K,
                              int ns, int parts, void* stream) {
  if (K % 8 != 0 || K < 8 || K > T_KC || parts < 1 || parts > 2)
    return cudaErrorInvalidValue;
  const int smem = 1024 + 64 * T_KC * 4 + T_KC * ns * 4 * parts;
  auto launch = [&](auto kernel) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<1, 128, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(A), static_cast<const float*>(Bp),
        static_cast<float*>(D), K, parts);
    return static_cast<int>(cudaGetLastError());
  };
  switch (ns) {
#define IRK_CASE(n) \
  case n:           \
    return launch(gemm_tile_tf32_kernel<n>);
    IRK_TF32_WIDTHS(IRK_CASE)
#undef IRK_CASE
    default:
      return cudaErrorInvalidValue;
  }
}
