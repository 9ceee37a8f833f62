// The Swin block's two kernels (replacing the TPU strip kernel
// image_restoration_agent_tpu/ops/pallas_attention.py:swin_strip_pallas,
// mlp_block_pallas, wmsa_block_pallas and, K2 alone, wmsa_pallas). See
// ops/swin_block.py for the blocks they make, what bounds them on the
// H100, and what is left for later work.
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
// K2 window_attention: every (window, head) of N = ws^2 <= 256 tokens
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
//   - float32 (window_attention_f32_kernel): one block per (window, head),
//     k and v staged once, 64-query chunks, QK^T and PV tiled in registers
//     on FP32 FMA (4 rows x N/16 keys, then 4 rows x 1-4 columns a thread).
//
// Plain C interface for ctypes; each entry returns cudaGetLastError().

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

// ---------------------------------------------------------------------------
// K2: window_attention (design in the note at the top of this file)

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
// reciprocal normalization; exact: max-subtracted, divided.
template <int CNT>
__device__ __forceinline__ void row_softmax(float* v, bool fast, int lanes) {
  float s = 0.f;
  if (fast) {
#pragma unroll
    for (int k = 0; k < CNT; ++k) {
      v[k] = fast_exp2(fminf(v[k], kExp2Clamp));
      s += v[k];
    }
    for (int o = 1; o <= lanes; o <<= 1)
      s += __shfl_xor_sync(0xffffffffu, s, o);
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
#pragma unroll
    for (int k = 0; k < CNT; ++k) v[k] /= s;
  }
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

// S (NT n8 tiles of keys j0 ..) = q k^T, and the logits ((q.k) * scale +
// bias) + mask (x log2 e in fast mode; -inf past N) of rows g and g + 8
// mw[r][k]: word k (keys j0 + 32 k ..) of row r's mask bits (bits form),
// or the dense rows m0.d, m1.d; neither where the window has no mask
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

// W16: the bias comes from the window-16 rows w0, w1 (BiasRow16) rather
// than from b0, b1 and cb
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

// bf16, N > 64: 16 query rows r0 .. of one head shared by a warp pair, in
// one pass: the warp of key half kh takes keys kh NP/2 .. +NP/2 (16 x NP/2
// logits, NP/4 registers a thread), and the two exchange through shared
// memory (xs, 16 x 2 floats a statistic; xo, the PV partials) under a
// named barrier: the row sums (exact mode: the row maxima, then the sums),
// after which each normalizes its own p in float32, rounds it to bf16
// into PV's A fragments and multiplies by its half of v; warp kh 1 hands
// its float32 partial O to warp kh 0, which adds it and stores the rows.
// Both warps sum the two halves' statistics as a + b and b + a: the same
// value, so p is the same as one warp's would be.
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
  float l[2] = {0.f, 0.f};
  if (fast) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = fast_exp2(fminf(s[nt][e], kExp2Clamp));
        l[e >> 1] += s[nt][e];
      }
    exchange(l, false, xs);
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
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] /= l[e >> 1];
  }
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
  if (kh == 1) {
#pragma unroll
    for (int nd = 0; nd < 2 * KD; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) xo[(nd * 4 + e) * 32 + lane] = acc[nd][e];
  }
  pair_sync(bar);
  if (kh == 0) {
#pragma unroll
    for (int nd = 0; nd < 2 * KD; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nd][e] += xo[(nd * 4 + e) * 32 + lane];
    store_rows<KD>(acc, o, C, hd, n, r0, g, t);
  }
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

// float32 kernel (exact arithmetic: FP32 FMA, no TF32). One block of 256
// threads per (window, head); the head's k and v staged once (cp.async,
// 16/8/4 bytes as the slice allows), q and the softmax in chunks of 64
// query rows. Per chunk:
//   - S = q k^T tiled in registers: thread (rg, cg) = (tid / 16, tid % 16)
//     holds rows 4 rg .. +3 and keys cg + 16 m (m < NP / 16); per 4 columns
//     of the head it reads 4 q and NP / 16 k float4s (conflict-free: the
//     16 lanes of a row group read 16 consecutive key rows);
//   - the softmax over the 16 lanes of a row group (xor shuffles);
//   - p^T written to shared memory, then O = p v tiled as rows 4 rg .. +3
//     and columns DPT cg .. +DPT-1 (one float4 of p and DPT v per key).
template <int NP, int DPT>
__global__ void __launch_bounds__(256)
    window_attention_f32_kernel(const Attn a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int LDQ = 16 * DPT + 4, LDP = 64 + 4;
  const int C = a.C, c3 = 3 * C, n = a.n, hd = C / a.heads;
  const int hd4 = (hd + 3) & ~3;
  const long long win = blockIdx.x / a.heads;
  const int h = static_cast<int>(blockIdx.x % a.heads);
  const int tid = threadIdx.x, rg = tid >> 4, cg = tid & 15;
  float* Qs = reinterpret_cast<float*>(smem);  // [64][LDQ]
  float* Ks = Qs + 64 * LDQ;                   // [NP][LDQ]
  float* Vs = Ks + NP * LDQ;                   // [NP][LDQ]
  float* Pt = Vs + NP * LDQ;                   // [NP][LDP]: p^T
  float* tab = Pt + NP * LDP;
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
    cp_async_w((which ? Vs : Ks) + i * LDQ + sg * we,
               src + static_cast<long long>(i) * c3 + (which + 1) * C +
                   sg * we,
               w);
  }
  // k's columns hd .. hd4 - 1 enter the products: zero; v's rows past N
  // meet p = 0: zero
  for (int e = tid; e < NP * (hd4 - hd); e += 256)
    Ks[(e / (hd4 - hd)) * LDQ + hd + e % (hd4 - hd)] = 0.f;
  for (int e = tid; e < (NP - n) * LDQ; e += 256) Vs[n * LDQ + e] = 0.f;
  stage_table(a, tab, h, 1);
  bias_cols(a, cb, NP);
  cp_async_commit();

  const float ls = a.fast ? kLog2e : 1.f;
  float* out = static_cast<float*>(a.out) + win * n * C + h * hd;
  for (int q0 = 0; q0 < n; q0 += 64) {
    const int nq = min(64, n - q0);
    __syncthreads();  // the previous chunk's q and p^T reads are done
    for (int e = tid; e < nq * segs; e += 256) {
      const int i = e / segs, sg = e - i * segs;
      cp_async_w(Qs + i * LDQ + sg * we,
                 src + static_cast<long long>(q0 + i) * c3 + sg * we, w);
    }
    for (int e = tid; e < nq * (hd4 - hd); e += 256)
      Qs[(e / (hd4 - hd)) * LDQ + hd + e % (hd4 - hd)] = 0.f;
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    float s[4][NP / 16];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int m = 0; m < NP / 16; ++m) s[r][m] = 0.f;
    for (int d = 0; d < hd4; d += 4) {
      float4 qv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        qv[r] = *reinterpret_cast<const float4*>(Qs + (4 * rg + r) * LDQ + d);
#pragma unroll
      for (int m = 0; m < NP / 16; ++m) {
        const float4 kv =
            *reinterpret_cast<const float4*>(Ks + (cg + 16 * m) * LDQ + d);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float v = s[r][m];
          v = fmaf(qv[r].x, kv.x, v);
          v = fmaf(qv[r].y, kv.y, v);
          v = fmaf(qv[r].z, kv.z, v);
          s[r][m] = fmaf(qv[r].w, kv.w, v);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = q0 + 4 * rg + r;
      const BiasRow br = bias_row(a, tab, 1, 0, h, i);
      const MaskRow mr = mask_row(a, entry, mb, i);
#pragma unroll
      for (int m = 0; m < NP / 16; ++m) {
        const int j = cg + 16 * m;
        float k = 0.f;
        if (mr.w != nullptr)
          k = (mr.w[m >> 1] >> (cg + 16 * (m & 1))) & 1u ? mr.val : 0.f;
        else if (mr.d != nullptr)
          k = mr.d[min(j, n - 1)];
        s[r][m] = j < n ? ((s[r][m] * a.scale + br(cb[j])) + k) * ls
                        : -INFINITY;
      }
      row_softmax<NP / 16>(s[r], a.fast, 8);
    }
#pragma unroll
    for (int m = 0; m < NP / 16; ++m)
      *reinterpret_cast<float4*>(Pt + (cg + 16 * m) * LDP + 4 * rg) =
          make_float4(s[0][m], s[1][m], s[2][m], s[3][m]);
    __syncthreads();

    float o[4][DPT];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < DPT; ++c) o[r][c] = 0.f;
    const float* vc = Vs + cg * DPT;
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const float4 pv = *reinterpret_cast<const float4*>(Pt + j * LDP + 4 * rg);
      const float p4[4] = {pv.x, pv.y, pv.z, pv.w};
      float vv[DPT];
      if constexpr (DPT == 4) {
        const float4 x = *reinterpret_cast<const float4*>(vc + j * LDQ);
        vv[0] = x.x;
        vv[1] = x.y;
        vv[2] = x.z;
        vv[3] = x.w;
      } else if constexpr (DPT == 2) {
        const float2 x = *reinterpret_cast<const float2*>(vc + j * LDQ);
        vv[0] = x.x;
        vv[1] = x.y;
      } else {
        vv[0] = vc[j * LDQ];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < DPT; ++c) o[r][c] = fmaf(p4[r], vv[c], o[r][c]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = q0 + 4 * rg + r;
      if (i >= n) continue;
#pragma unroll
      for (int c = 0; c < DPT; ++c)
        if (cg * DPT + c < hd) out[i * C + cg * DPT + c] = o[r][c];
    }
  }
}

size_t attention_f32_smem(int np, int dpt, int L, int n, int mw) {
  const size_t ldq = 16 * dpt + 4;
  return ((64 + 2 * static_cast<size_t>(np)) * ldq +
          static_cast<size_t>(np) * 68 + L + np +
          static_cast<size_t>(n) * mw) *
         4;
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
// x * 1.0f is exact).
extern "C" int window_attention(const void* qkv, int dt, const void* rpb,
                                const void* table, int ws, const void* bank,
                                int bank_zero, const void* mask, int nmask,
                                const void* bits, float mval, void* out,
                                int nwin, int n, int C, int heads, int nwy,
                                int nwx, int fast, float scale,
                                void* stream) {
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
  auto launch = [&](auto kernel, unsigned blocks, size_t smem) {
    if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<blocks, 256, smem, s>>>(a);
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
  const int dpt = hd <= 16 ? 1 : hd <= 32 ? 2 : 4;
  const size_t smem = attention_f32_smem(np, dpt, L, n, mw);
  switch (np * 10 + dpt) {
#define IRK_CASE(NP, DPT)                                                  \
  case NP * 10 + DPT:                                                      \
    return launch(window_attention_f32_kernel<NP, DPT>, per_head, smem);
    IRK_CASE(64, 1) IRK_CASE(64, 2) IRK_CASE(64, 4)
    IRK_CASE(128, 1) IRK_CASE(128, 2) IRK_CASE(128, 4)
    IRK_CASE(256, 1) IRK_CASE(256, 2) IRK_CASE(256, 4)
#undef IRK_CASE
    default:
      return cudaErrorInvalidValue;
  }
}
