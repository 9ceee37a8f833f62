// K8: a pair of Swin blocks in one launch, replacing the TPU kernel
// image_restoration_agent_tpu/ops/pallas_attention.py:swin_pair_strip_pallas
// (body _strip_kernel_pairfused). See ops/swin_block.py:swin_pair_block for
// the function: block A (unshifted, read through roll(x, dc1)) then block B
// (shifted, read through roll(A's output, -ws/2), the mask bank), the fast
// numerics of the port's swin_block, the output in frame -ws/2.
//
// Geometry: in the rolled frame, B's window (wy, wx) covers a quarter (ws/2
// x ws/2) of each of the four A windows (wy + {0,1}, wx + {0,1}), indices
// modulo the window counts (the last row and column wrap to the first). B's
// token (by, bx) is pixel (wy ws + ws/2 + by, wx ws + ws/2 + bx) of A's
// frame, at ((by + ws/2) mod ws, (bx + ws/2) mod ws) of its A window. Block
// A's output never reaches device memory. A's LN1, k and v run four times
// (once per B window that needs the A window): at C 180, N 64, 9.7e7 FLOP a
// window against the pair's own 7.2e7.
//
// Numerics (the port's fast swin_block, kernels K1 and K2): LN in float32,
// the operand rounded to the canvas dtype; q, k, v in the canvas dtype (q
// carries the attention scale from the weights); logits (q.k + rpb (+
// bank)) * log2(e) in float32, exp2(min(l, 86.56)), a reciprocal
// normalization, p rounded before p.v; the attention output in the canvas
// dtype; proj + residual in float32 (x1), kept in float32 into the MLP
// half; tanh-GELU, the hidden activation rounded; fc2's products summed
// onto x1, then + b2, cast once (another order than K1's fc2, float32
// rounding).
//
// What bounds it: at the SwinIR-M band (552x1920, C 180) the pair is
// 1.20e12 FLOP of its own work against 0.76 GB of input and output: the
// tensor cores (1.2 ms bf16; 7.25 ms in f32 at three TF32 passes).
//
// bf16 (swin_pair_mma_kernel, Hopper): persistent blocks (one an SM), each
// walking B windows; two warpgroups, 255 registers a thread.
//   - Every product is a 64-row wgmma (sm90_gemm.cuh): A from shared memory
//     by ldmatrix into registers (wgmma_rs), B by descriptor from a ring of
//     four 18 KB weight stages that thread 0 fills by 1-D bulk copies
//     (cp.async.bulk, completion counted on an mbarrier) from the
//     packed form (ops/swin_block.py:swin_pair_weights: each pass's K x N
//     weight as no-swizzle K-major core matrices, one stage a contiguous
//     run of k rows); each warp releases a stage on a
//     second mbarrier once its products are done, and thread 0 then
//     refills the slot with the stage four ahead in the block's fixed
//     sequence of stages (a table in shared memory), so the next pass's
//     first stages land during the attention and LayerNorm phases. No
//     weight fragment is read from device memory inside a k loop.
//     Warpgroup w takes the columns [w N/2, (w + 1) N/2) of every pass.
//     A stage holds the most of 64, 48, 32 or 16 k rows that divides K and
//     fits 18 KB (48 at C 180).
//     (A producer warpgroup with setmaxnreg, 40 and 232 registers, was
//     tried: the kernel is compiled for the 168 a thread that 384 threads
//     launch with, spilled 8.6 KB and serialized its wgmma, 70.9 ms at the
//     band; PERF.md, section 6.)
//   - Per B window, in stage order: A's LN1 and q on B's 64 tokens at once
//     (the four quarters); for each of the four A windows, LN1 of its
//     tokens from device memory, k and v of every head (two m64 x nq passes), then
//     the quarter's 16 queries of every head against them; A's proj +
//     residual into float32 registers (x1), LN2 from those registers (the
//     two warpgroups' halves of a row exchanged through shared memory),
//     fc1 + tanh-GELU, and fc2 summed onto x1: A's output, cast, is B's
//     input tile in shared memory. Then block B on that tile (q and kv
//     passes from one LN1), its attention (4 row blocks x heads tasks),
//     proj, LN2, fc1, fc2, stored to the output frame.
//   - Attention: K2's N <= 64 form on mma.sync m16n8k16, one warp a (16
//     queries, head) task: the logits and p in registers, p rounded to
//     bf16 straight into PV's A fragments, v by ldmatrix.trans; the dense
//     relative-position bias and the bank's rows read as float2 (the bank
//     entries that the wrapper found all zero skipped).
//   - Epilogues from the accumulator registers: bias, residual, LN2's
//     statistics, tanh-GELU, the casts and the stores.
//   - The A windows' rows are gathered from device memory by cp.async
//     into two buffers in turn, the next window's in flight while one is
//     normalized in place, multiplied and attended.
//   - Shared memory (C 180): B's tile, the LN output, the second gather
//     buffer, q / the attention output, k and v / the hidden activation
//     (4 x 25.6 + 50.2 KB) and the ring (72 KB): one block an SM.
// float32 (swin_pair_tf32_kernel, Hopper): split TF32 on mma.sync m16n8k8,
// every product xl wh + xh wl + xh wh summed in float32; one block (eight
// warps) a B window, the bf16 kernel's order of phases.
//   - In float32 the bf16 plan's activations alone (X, Y, the gather
//     buffer, q, k and v of every head, the hidden activation: 300 KB at C
//     180) exceed the card, so the schedule changes: k and v are built a
//     head group at a time (the most heads whose k | v fit; 3 at C 180)
//     and each group's attention runs before the next; fc1's hidden
//     activation comes a chunk of nq columns at a time, each chunk's fc2
//     partial added onto x1 in float32 (K4's project_out pattern); A's
//     windows are gathered into the LN buffer in turn, no second buffer.
//     Four regions of 64 rows (X, Y; q / the attention output / fc1's
//     chunk; a group's k | v / x1): 196.6 KB at C 180, one block an SM.
//   - Products (gemm64): a warp takes a run of three 8-column n-tiles of
//     all 64 rows (12 m16n8k8 tiles, 36 mma a k8 step); A's fragments by
//     ldmatrix.x4 from the float32 rows (16-byte rows of 4 floats: the
//     b16 matrices' words are the TF32 fragment), split in registers by
//     integer ops (common.cuh: split1); the weights arrive split from the
//     form (ops/swin_block.py:swin_pair_f32_weights), packed so that a
//     lane's {wh, wl} fragment of a k8 step is one 16-byte load, read from
//     L2 (the block's weights, 3.6 MB at C 180, stay there) one k8 step
//     ahead. No weight staging: shared memory holds the activations.
//   - Attention (attn_tf32): one warp a (16 queries, head) task as the bf16
//     kernel's, on mma.sync m16n8k8 TF32 (K2's float32 products): q and p
//     split in registers, k and v split as they are read from shared
//     memory, p passed from the logits' layout to PV's A fragments by
//     shuffles, float32 exp2 and the reciprocal normalization.
//   - x1 (proj + bias + residual) stays in shared memory in float32, as
//     the FMA kernel kept it; LN2 reads it, fc2's chunks add onto it.
// What bounds it (float32): 3 x 1.20e12 TF32 FLOP at the band, 7.25 ms at
// 495 TFLOP/s; A's k and v for four windows a B window (1.35x the pair's
// own work) and mma.sync's TF32 rate (PR 20: about a quarter of wgmma's
// peak on K4) hold it further from that.
//
// Plain C interface for ctypes; each entry returns cudaGetLastError().

#include "common.cuh"
#include "sm90_gemm.cuh"

using namespace irk;

namespace {

constexpr float LOG2E = 1.4426950408889634f;

__host__ __device__ inline size_t take(size_t& o, size_t bytes) {
  const size_t at = o;
  o = (o + bytes + 127) / 128 * 128;
  return at;
}

// ---------------------------------------------------------------------------
// bf16 on Hopper (swin_pair_mma_kernel): see the note at the top of the file.

constexpr int P_NT = 256;               // two warpgroups
constexpr int P_MAXSEQ = 128;           // stages a window, at most
constexpr int P_SLOT = 18432;           // bytes of one weight stage
constexpr int P_STAGES = 4;             // the ring
constexpr float P_CLAMP = 86.56f;       // 60 * log2(e): the TPU kernel's clamp

// one block's packed weights (ops/swin_block.py:swin_pair_weights), in the
// order of the pointer array
struct PairW {
  const __nv_bfloat16 *wq, *wkv, *wproj, *w1, *w2;
  const float *bq, *bkv, *bproj, *b1, *b2, *ln1, *ln2, *rpb;
};

struct PGeo {
  int B, H, W, C, heads, hdp, ws, dc1, nwy, nwx, n;
  int kp, kq, nq, nc, nh;  // padded widths (the wrapper's SwinPairForm)
  int ldx, ldq, ldkv;      // shared-memory pitches (bf16 elements)
  long long nwin;
  int bank_zero;
};

struct PLay {
  size_t bars, seq, pw, red, x, y, ga, q, kv, ring, total;
};

__host__ __device__ inline PLay pair_layout(const PGeo& g) {
  PLay l;
  size_t o = 0;
  l.bars = take(o, 2 * P_STAGES * 8);
  l.seq = take(o, P_MAXSEQ * 8);
  l.pw = take(o, 2 * sizeof(PairW));
  l.red = take(o, 2 * 2 * 64 * 4);
  l.x = take(o, 64 * static_cast<size_t>(g.ldx) * 2);
  l.y = take(o, 64 * static_cast<size_t>(g.ldx) * 2);
  l.ga = take(o, 64 * static_cast<size_t>(g.ldx) * 2);
  l.q = take(o, 64 * static_cast<size_t>(g.ldq) * 2);
  l.kv = take(o, 64 * static_cast<size_t>(g.ldkv) * 2);
  l.ring = take(o, static_cast<size_t>(P_STAGES) * P_SLOT);
  l.total = o;
  return l;
}

// k rows a weight stage holds for a pass of K x N: the most, of 64, 48,
// 32, 16, that divides K and fits a slot
__host__ __device__ inline int stage_k(int K, int N) {
  int kc = 64;
  while (kc > 16 && (K % kc || kc * N * 2 > P_SLOT)) kc -= 16;
  return kc;
}

// the stages of one window: A's q, 4 x (k, v), proj, fc1 (two halves),
// fc2; B's q, k, v, proj, fc1 (two halves), fc2
__host__ __device__ inline int pair_stages(const PGeo& g) {
  const int q = g.kp / stage_k(g.kp, g.nq), pr = g.kq / stage_k(g.kq, g.nc);
  const int f1 = g.kp / stage_k(g.kp, g.nh / 2);
  const int f2 = g.nh / stage_k(g.nh, g.nc);
  return 2 * (q + pr + 2 * f1 + f2) + 8 * q + 2 * q;
}

using Ring = StageRing<P_STAGES, P_SLOT>;

// One product pass of a warpgroup: acc (+)= A[64 x K] . Wp[:, n0 .. n0 +
// NW), A row-major bf16 in shared memory (pitch lda), Wp the pass's packed
// K x N weight, streamed through the ring one stage (stage_k k rows) at
// a time: A's fragments by ldmatrix into registers, wgmma_rs on the stage
// by descriptor; the stage is released once its products are done. With
// acc_in the first product adds to acc.
template <int NW>
__device__ __forceinline__ void pass(float (&acc)[NW / 2],
                                     const __nv_bfloat16* A, int lda, int K,
                                     int N, int n0, Ring& r, bool acc_in) {
  const int lane = threadIdx.x % 32, wq = (threadIdx.x / 32) % 4;
  const int kc = stage_k(K, N), ksteps = kc / 16;
  const __nv_bfloat16* arow =
      A + (16 * wq + frag_row(lane)) * lda + 8 * frag_khalf(lane);
  for (int k0 = 0; k0 < K; k0 += kc) {
    uint32_t a[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      if (ks < ksteps) ldmatrix_x4(a[ks], arow + k0 + 16 * ks);
    const unsigned char* ws = r.wait() + (n0 / 8) * 128;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      if (ks < ksteps)
        wgmma_rs<NW>(acc, a[ks], b_desc(ws + ks * N * 32, N * 16),
                     acc_in || k0 > 0 || ks > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(a);
    r.release();
  }
}

// f(row, col, v0, v1) for the accumulator pairs of a warpgroup's m64 x NW
// slice starting at column n0 (columns col, col + 1 of row `row`)
template <int NW, typename F>
__device__ __forceinline__ void each_pair(float (&acc)[NW / 2], int n0, F f) {
  const int lane = threadIdx.x % 32, wq = (threadIdx.x / 32) % 4;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NW / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      f(16 * wq + g + 8 * h, n0 + 8 * j + 2 * t, acc[4 * j + 2 * h],
        acc[4 * j + 2 * h + 1]);
}

// acc + bias -> bf16 pairs into D (pitch ld)
template <int NW>
__device__ __forceinline__ void store_bias(float (&acc)[NW / 2], int n0,
                                           const float* __restrict__ bias,
                                           __nv_bfloat16* D, int ld) {
  const float* bv = opaque(bias);
  each_pair<NW>(acc, n0, [&](int r, int c, float v0, float v1) {
    const float2 b = ldg2(bv + c);
    *reinterpret_cast<uint32_t*>(D + r * ld + c) =
        pack_bf16(v0 + b.x, v1 + b.y);
  });
}

// Rows r < n of the canvas (src(r): C bf16 values of a pixel) into dst
// (pitch ld) by cp.async, every copy in flight at once (8 bytes where C %
// 4 == 0, else 4; a warp a row at a time, src called once a row); rows past
// n zero. The caller waits and syncs.
template <typename Src>
__device__ __forceinline__ void gather64(__nv_bfloat16* dst, int ld, int n,
                                         int C, const __nv_bfloat16* any,
                                         Src src) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int w = (C & 3) == 0 ? 4 : 2;  // bf16 values a copy
#pragma unroll 1
  for (int r = warp; r < 64; r += P_NT / 32) {
    const __nv_bfloat16* sp = r < n ? src(r) : any;
    __nv_bfloat16* dp = dst + r * ld;
    for (int c = w * lane; c < C; c += 32 * w) {
      if (w == 4)
        cp_async8z(dp + c, sp + c, r < n ? 8 : 0);
      else if (r < n)
        cp_async4(dp + c, sp + c);
      else
        *reinterpret_cast<uint32_t*>(dp + c) = 0u;
    }
  }
  cp_async_commit();
}

// LayerNorm (float32 two-pass statistics, eps 1e-5) of the 64 rows src(r)
// (C bf16 values each, nullptr: a zero row) into Y (pitch ld), C <= 256:
// a warp normalizes LN_ROWS rows at once (r, r + 8, ...), their shuffles
// interleaved, a lane holding channel pairs 2 (lane + 32 i); src(r) may be
// Y's own row r. Columns past C are left as they are.
constexpr int LN_ROWS = 4;

template <typename Src>
__device__ __forceinline__ void ln_rows64(Src src, int C,
                                          const float* __restrict__ lnp,
                                          __nv_bfloat16* Y, int ld) {
  constexpr int R = LN_ROWS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  lnp = opaque(lnp);
  float2 gm[4], bt[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = 2 * (lane + 32 * i);
    gm[i] = bt[i] = make_float2(0.f, 0.f);
    if (k < C) {
      gm[i] = ldg2(lnp + k);
      bt[i] = ldg2(lnp + C + k);
    }
  }
#pragma unroll 1
  for (int r0 = warp; r0 < 64; r0 += R * (P_NT / 32)) {
    float2 v[R][4];
    float s[R], d2[R];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const __nv_bfloat16* p = src(r0 + 8 * q);
      s[q] = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = 2 * (lane + 32 * i);
        v[q][i] = p != nullptr && k < C
                      ? __bfloat1622float2(
                            *reinterpret_cast<const __nv_bfloat162*>(p + k))
                      : make_float2(0.f, 0.f);
        s[q] += v[q][i].x + v[q][i].y;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int q = 0; q < R; ++q)
        s[q] += __shfl_xor_sync(0xffffffffu, s[q], o);
#pragma unroll
    for (int q = 0; q < R; ++q) {
      s[q] /= C;
      d2[q] = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (2 * (lane + 32 * i) >= C) continue;
        const float a = v[q][i].x - s[q], b = v[q][i].y - s[q];
        d2[q] += a * a + b * b;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int q = 0; q < R; ++q)
        d2[q] += __shfl_xor_sync(0xffffffffu, d2[q], o);
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int r = r0 + 8 * q;
      const bool zero = src(r) == nullptr;
      const float rs = rsqrtf(d2[q] / C + 1e-5f);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = 2 * (lane + 32 * i);
        if (k >= C) continue;
        *reinterpret_cast<uint32_t*>(Y + r * ld + k) =
            zero ? 0u
                 : pack_bf16((v[q][i].x - s[q]) * rs * gm[i].x + bt[i].x,
                             (v[q][i].y - s[q]) * rs * gm[i].y + bt[i].y);
      }
    }
  }
}

// proj + bias + residual (x1, float32, in the proj accumulators), then its
// LayerNorm (float32 two-pass statistics over C, the two warpgroups' halves
// of each row exchanged through red) rounded to bf16 into Y. Columns past
// C of x1 are 0.
template <int NCW>
__device__ __forceinline__ void x1_ln2(float (&x1)[NCW / 2], int n0,
                                       const PGeo& g, const PairW& w,
                                       const __nv_bfloat16* X, float* red,
                                       __nv_bfloat16* Y) {
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  const int t = lane & 3;
  const int C = g.C;
  const float* bproj = opaque(w.bproj);
  const float* ln2 = opaque(w.ln2);
  float s[2] = {0.f, 0.f};
  const int wq = (threadIdx.x / 32) % 4, gq = lane >> 2;
#pragma unroll
  for (int j = 0; j < NCW / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * wq + gq + 8 * h, c = n0 + 8 * j + 2 * t;
      float& v0 = x1[4 * j + 2 * h];
      float& v1 = x1[4 * j + 2 * h + 1];
      if (c < C) {
        const float2 b = ldg2(bproj + c);
        const float2 res = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(X + r * g.ldx + c));
        v0 = v0 + b.x + res.x;
        v1 = v1 + b.y + res.y;
      } else {
        v0 = v1 = 0.f;
      }
      s[h] += v0 + v1;
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    s[h] += __shfl_xor_sync(0xffffffffu, s[h], 1);
    s[h] += __shfl_xor_sync(0xffffffffu, s[h], 2);
  }
  const int r0 = 16 * wq + gq;
  if (t == 0) {
    red[wg * 64 + r0] = s[0];
    red[wg * 64 + r0 + 8] = s[1];
  }
  __syncthreads();
  float mu[2], d2[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h)
    mu[h] = (red[r0 + 8 * h] + red[64 + r0 + 8 * h]) / C;
#pragma unroll
  for (int j = 0; j < NCW / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (n0 + 8 * j + 2 * t >= C) continue;
      const float a = x1[4 * j + 2 * h] - mu[h];
      const float b = x1[4 * j + 2 * h + 1] - mu[h];
      d2[h] += a * a + b * b;
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    d2[h] += __shfl_xor_sync(0xffffffffu, d2[h], 1);
    d2[h] += __shfl_xor_sync(0xffffffffu, d2[h], 2);
  }
  if (t == 0) {
    red[128 + wg * 64 + r0] = d2[0];
    red[128 + wg * 64 + r0 + 8] = d2[1];
  }
  __syncthreads();
  float rs[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    rs[h] = rsqrtf((red[128 + r0 + 8 * h] + red[192 + r0 + 8 * h]) / C +
                   1e-5f);
#pragma unroll
  for (int j = 0; j < NCW / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h, c = n0 + 8 * j + 2 * t;
      if (c >= C) continue;
      const float2 gm = ldg2(ln2 + c);
      const float2 bt = ldg2(ln2 + C + c);
      *reinterpret_cast<uint32_t*>(Y + r * g.ldx + c) = pack_bf16(
          (x1[4 * j + 2 * h] - mu[h]) * rs[h] * gm.x + bt.x,
          (x1[4 * j + 2 * h + 1] - mu[h]) * rs[h] * gm.y + bt.y);
    }
}

// tanh-GELU as 0.5 v (1 + tanh(y)) = v / (1 + e^(-2y)), y = 0.79788456 (v
// + 0.044715 v^3): the same function as gelu_tanh (the f32 path's, and
// K1's tanhf) to a few float32 ulps (__expf and a division), without
// tanhf's branches; the result is rounded to bf16 at once
__device__ __forceinline__ float gelu_sig(float v) {
  const float y = 0.7978845608f * (v + 0.044715f * v * v * v);
  return __fdividef(v, 1.f + __expf(-2.f * y));
}

// 2^x, the MUFU instruction alone (subnormal results flushed to 0)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One warp's attention task: 16 query rows of one head (query i of the
// task in row qrow[i] of Q, -1 where it has none; its bias row brow[i] of
// rpb), the n keys and values of KV, all on mma.sync m16n8k16 (K2's N <= 64
// form): the 16 x 64 logits in registers, ((q.k) + rpb (+ mask)) * log2 e,
// exp2(min(l, 86.56)), a reciprocal normalization, p rounded to bf16 as
// PV's A fragments, the output rounded to bf16 into the query rows of Q
// (each task reads its q before it writes). mask: the (n, n) rows of the
// window's bank entry, or nullptr.
template <int KD>
__device__ __forceinline__ void attn16(__nv_bfloat16* Q, int ldq,
                                       const int (&qrow)[2],
                                       const int (&brow)[2],
                                       const __nv_bfloat16* KV, int ldkv,
                                       int nq, int h, int n,
                                       const float* __restrict__ rpb,
                                       const float* __restrict__ mask) {
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  constexpr int HDP = 16 * KD;
  const __nv_bfloat16* q0 = Q + (qrow[0] < 0 ? 0 : qrow[0]) * ldq + h * HDP;
  const __nv_bfloat16* q1 = Q + (qrow[1] < 0 ? 0 : qrow[1]) * ldq + h * HDP;
  uint32_t qa[KD][4];
#pragma unroll
  for (int kd = 0; kd < KD; ++kd) {
    const int c = 16 * kd + 2 * t;
    qa[kd][0] = *reinterpret_cast<const uint32_t*>(q0 + c);
    qa[kd][1] = *reinterpret_cast<const uint32_t*>(q1 + c);
    qa[kd][2] = *reinterpret_cast<const uint32_t*>(q0 + c + 8);
    qa[kd][3] = *reinterpret_cast<const uint32_t*>(q1 + c + 8);
  }
  const __nv_bfloat16* kb = KV + h * HDP;
  float s[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    if (8 * nt >= n) continue;
    const __nv_bfloat16* kr = kb + (8 * nt + g) * ldkv;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      const int c = 16 * kd + 2 * t;
      mma_bf16(s[nt], qa[kd], *reinterpret_cast<const uint32_t*>(kr + c),
               *reinterpret_cast<const uint32_t*>(kr + c + 8));
    }
  }
  const float* b0 = rpb + (static_cast<long long>(h) * n + brow[0]) * n;
  const float* b1 = rpb + (static_cast<long long>(h) * n + brow[1]) * n;
  const float* m0 = mask != nullptr ? mask + brow[0] * n : nullptr;
  const float* m1 = mask != nullptr ? mask + brow[1] * n : nullptr;
  float r0v[16], r1v[16];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int j = 8 * nt + 2 * t;
    float2 c0 = make_float2(-INFINITY, -INFINITY), c1 = c0;
    if (j < n) {  // n even: j + 1 < n too
      const float2 p0 = __ldg(reinterpret_cast<const float2*>(b0 + j));
      const float2 p1 = __ldg(reinterpret_cast<const float2*>(b1 + j));
      float2 k0 = make_float2(0.f, 0.f), k1 = k0;
      if (m0 != nullptr) {
        k0 = __ldg(reinterpret_cast<const float2*>(m0 + j));
        k1 = __ldg(reinterpret_cast<const float2*>(m1 + j));
      }
      c0 = make_float2(((s[nt][0] + p0.x) + k0.x) * LOG2E,
                       ((s[nt][1] + p0.y) + k0.y) * LOG2E);
      c1 = make_float2(((s[nt][2] + p1.x) + k1.x) * LOG2E,
                       ((s[nt][3] + p1.y) + k1.y) * LOG2E);
    }
    r0v[2 * nt] = c0.x;
    r0v[2 * nt + 1] = c0.y;
    r1v[2 * nt] = c1.x;
    r1v[2 * nt + 1] = c1.y;
  }
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    r0v[k] = exp2_ftz(fminf(r0v[k], P_CLAMP));
    r1v[k] = exp2_ftz(fminf(r1v[k], P_CLAMP));
    s0 += r0v[k];
    s1 += r1v[k];
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    s0 += __shfl_xor_sync(0xffffffffu, s0, o);
    s1 += __shfl_xor_sync(0xffffffffu, s1, o);
  }
  const float i0 = 1.f / s0, i1 = 1.f / s1;
  float acc[2 * KD][4];
#pragma unroll
  for (int nd = 0; nd < 2 * KD; ++nd)
    acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;
  const __nv_bfloat16* vb = kb + nq;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (16 * kk >= n) continue;
    const uint32_t pa[4] = {
        pack_bf16(r0v[4 * kk] * i0, r0v[4 * kk + 1] * i0),
        pack_bf16(r1v[4 * kk] * i1, r1v[4 * kk + 1] * i1),
        pack_bf16(r0v[4 * kk + 2] * i0, r0v[4 * kk + 3] * i0),
        pack_bf16(r1v[4 * kk + 2] * i1, r1v[4 * kk + 3] * i1)};
    const __nv_bfloat16* vr =
        vb + (16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1)) * ldkv +
        8 * (lane >> 4);
#pragma unroll
    for (int nd2 = 0; nd2 < KD; ++nd2) {
      uint32_t v4[4];
      ldmatrix_x4_trans(v4, vr + 16 * nd2);
      mma_bf16(acc[2 * nd2], pa, v4[0], v4[1]);
      mma_bf16(acc[2 * nd2 + 1], pa, v4[2], v4[3]);
    }
  }
  __syncwarp();  // every lane's q is read before any lane writes
#pragma unroll
  for (int nd = 0; nd < 2 * KD; ++nd) {
    const int c = h * HDP + 8 * nd + 2 * t;
    if (qrow[0] >= 0)
      *reinterpret_cast<uint32_t*>(Q + qrow[0] * ldq + c) =
          pack_bf16(acc[nd][0], acc[nd][1]);
    if (qrow[1] >= 0)
      *reinterpret_cast<uint32_t*>(Q + qrow[1] * ldq + c) =
          pack_bf16(acc[nd][2], acc[nd][3]);
  }
}

// k then v of every head from the LN rows Y (two passes of nq columns),
// into KV as [k of every head | v of every head]
template <int NQW>
__device__ __forceinline__ void kv_passes(const PGeo& g, const PairW& w,
                                          Ring& rg, const __nv_bfloat16* Y,
                                          __nv_bfloat16* KV) {
  const int wg = threadIdx.x / 128;
#pragma unroll 1
  for (int u = 0; u < 2; ++u) {
    float acc[NQW / 2];
    pass<NQW>(acc, Y, g.ldx, g.kp, g.nq, wg * NQW, rg, false);
    store_bias<NQW>(acc, wg * NQW, w.bkv + u * g.nq, KV + u * g.nq, g.ldkv);
  }
}

// The block's second half on the 64 rows of its attention output (in Q)
// with the residual X: proj + bias + residual into float32 registers (x1),
// LN2 into Y, fc1 + tanh-GELU into the hidden activation (KV's place), and
// fc2 summed onto x1; store(r, c, v0, v1) takes columns c, c + 1 (< C) of
// row r of x1 + fc2 + b2.
template <int NCW, int NHW, typename St>
__device__ __forceinline__ void proj_mlp64(const PGeo& g, const PairW& w,
                                           Ring& rg, const __nv_bfloat16* Q,
                                           const __nv_bfloat16* X,
                                           __nv_bfloat16* Y,
                                           __nv_bfloat16* KV, float* red,
                                           St store) {
  const int wg = threadIdx.x / 128;
  float x1[NCW / 2];
  const float* b1 = opaque(w.b1);
  const float* b2 = opaque(w.b2);
  pass<NCW>(x1, Q, g.ldq, g.kq, g.nc, wg * NCW, rg, false);
  x1_ln2<NCW>(x1, wg * NCW, g, w, X, red, Y);
  __syncthreads();
#pragma unroll 1
  for (int half = 0; half < 2; ++half) {  // fc1's two column halves
    const int h0 = half * (g.nh / 2);
    float acc[NHW / 2];
    pass<NHW>(acc, Y, g.ldx, g.kp, g.nh / 2, wg * NHW, rg, false);
    each_pair<NHW>(acc, h0 + wg * NHW, [&](int r, int c, float v0, float v1) {
      const float2 bb = ldg2(b1 + c);
      *reinterpret_cast<uint32_t*>(KV + r * g.ldkv + c) =
          pack_bf16(gelu_sig(v0 + bb.x), gelu_sig(v1 + bb.y));
    });
  }
  __syncthreads();
  pass<NCW>(x1, KV, g.ldkv, g.nh, g.nc, wg * NCW, rg, true);
  each_pair<NCW>(x1, wg * NCW, [&](int r, int c, float v0, float v1) {
    if (c >= g.C) return;
    const float2 bb = ldg2(b2 + c);
    store(r, c, v0 + bb.x, v1 + bb.y);
  });
}

PairW pair_w(const void* const* p) {
  PairW w;
  w.wq = static_cast<const __nv_bfloat16*>(p[0]);
  w.wkv = static_cast<const __nv_bfloat16*>(p[1]);
  w.wproj = static_cast<const __nv_bfloat16*>(p[2]);
  w.w1 = static_cast<const __nv_bfloat16*>(p[3]);
  w.w2 = static_cast<const __nv_bfloat16*>(p[4]);
  w.bq = static_cast<const float*>(p[5]);
  w.bkv = static_cast<const float*>(p[6]);
  w.bproj = static_cast<const float*>(p[7]);
  w.b1 = static_cast<const float*>(p[8]);
  w.b2 = static_cast<const float*>(p[9]);
  w.ln1 = static_cast<const float*>(p[10]);
  w.ln2 = static_cast<const float*>(p[11]);
  w.rpb = static_cast<const float*>(p[12]);
  return w;
}

// The widths that an instantiation fixes (the C it holds lies in (2 w',
// 2 NCW], w' the instantiated width below NCW, so C padded to 64 is NCW
// padded to 32, doubled)
template <int NQW, int NCW, int NHW, int KD>
__host__ __device__ inline void set_dims(PGeo& g) {
  g.hdp = 16 * KD;
  g.nq = 2 * NQW;
  g.nc = 2 * NCW;
  g.nh = 4 * NHW;
  g.kp = (2 * NCW + 63) / 64 * 64;
  g.kq = (2 * NQW + 63) / 64 * 64;
  g.ldx = g.kp + 8;
  g.ldq = g.kq + 8;
  g.ldkv = (4 * NQW > 4 * NHW ? 4 * NQW : 4 * NHW) + 8;
}

// NQW, NCW, NHW: the widths of one warpgroup's slice of q, k and v (NQW),
// proj and fc2 (NCW), each half of fc1 (NHW); KD = head width (padded) / 16
template <int NQW, int NCW, int NHW, int KD>
__global__ void __launch_bounds__(P_NT, 1) swin_pair_mma_kernel(
    const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ out,
    PairW wa, PairW wb, const float* __restrict__ bank, PGeo gp) {
  extern __shared__ __align__(128) unsigned char smem[];
  // the padded widths and pitches as constants of the instantiation (the
  // launcher checks that the form's match): shared-memory addresses are
  // then a register and an immediate, and the persistent loop's invariant
  // addresses do not take a register each
  PGeo g = gp;
  set_dims<NQW, NCW, NHW, KD>(g);
  const PLay L = pair_layout(g);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + P_STAGES;
  float* red = reinterpret_cast<float*>(smem + L.red);
  __nv_bfloat16* X = reinterpret_cast<__nv_bfloat16*>(smem + L.x);
  __nv_bfloat16* Y = reinterpret_cast<__nv_bfloat16*>(smem + L.y);
  __nv_bfloat16* G = reinterpret_cast<__nv_bfloat16*>(smem + L.ga);
  __nv_bfloat16* Q = reinterpret_cast<__nv_bfloat16*>(smem + L.q);
  __nv_bfloat16* KV = reinterpret_cast<__nv_bfloat16*>(smem + L.kv);
  unsigned char* ring = smem + L.ring;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ws = g.ws, s = ws / 2, n = g.n, C = g.C;

  unsigned long long* seq = reinterpret_cast<unsigned long long*>(smem + L.seq);
  PairW* ws2 = reinterpret_cast<PairW*>(smem + L.pw);  // wa, wb
  const long long nmine =
      blockIdx.x < g.nwin ? (g.nwin - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  if (tid == 0) {
    ws2[0] = wa;
    ws2[1] = wb;
    for (int i = 0; i < P_STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], P_NT / 32);
    }
    fence_barrier_init();
    // one window's stages, in the order the passes consume them
    int k = 0;
    auto add = [&](const __nv_bfloat16* wp, int K, int N) {
      const int kc = stage_k(K, N);
      for (int k0 = 0; k0 < K; k0 += kc)
        seq[k++] = seq_entry(wp + static_cast<long long>(k0) * N,
                             static_cast<uint32_t>(kc) * N * 2);
    };
    add(wa.wq, g.kp, g.nq);
    const long long kvh = static_cast<long long>(g.kp) * g.nq;
    const long long f1h = static_cast<long long>(g.kp) * (g.nh / 2);
    for (int qd = 0; qd < 4; ++qd) {
      add(wa.wkv, g.kp, g.nq);
      add(wa.wkv + kvh, g.kp, g.nq);
    }
    add(wa.wproj, g.kq, g.nc);
    add(wa.w1, g.kp, g.nh / 2);
    add(wa.w1 + f1h, g.kp, g.nh / 2);
    add(wa.w2, g.nh, g.nc);
    add(wb.wq, g.kp, g.nq);
    add(wb.wkv, g.kp, g.nq);
    add(wb.wkv + kvh, g.kp, g.nq);
    add(wb.wproj, g.kq, g.nc);
    add(wb.w1, g.kp, g.nh / 2);
    add(wb.w1 + f1h, g.kp, g.nh / 2);
    add(wb.w2, g.nh, g.nc);
  }
  // pad columns that no pass writes and a product reads: Y past C (to
  // kp), Q past nq (to kq)
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  for (int e = tid; e < 64 * (g.kp - C); e += P_NT) {
    const int at = (e / (g.kp - C)) * g.ldx + C + e % (g.kp - C);
    Y[at] = G[at] = zero;
  }
  for (int e = tid; e < 64 * (g.kq - g.nq); e += P_NT)
    Q[(e / (g.kq - g.nq)) * g.ldq + g.nq + e % (g.kq - g.nq)] = zero;
  __syncthreads();
  const int nseq = pair_stages(g);
  Ring rg{ring, full, empty, seq, nseq, 0,
          static_cast<uint32_t>(nmine * nseq)};
  rg.start();

  // warpgroup wg takes the columns [wg N/2, (wg + 1) N/2) of every pass
  const int wg = warp / 4;
  for (long long win = blockIdx.x; win < g.nwin; win += gridDim.x) {
    long long bid = win;
    const int wx = static_cast<int>(bid % g.nwx);
    bid /= g.nwx;
    const int wy = static_cast<int>(bid % g.nwy);
    const long long b = bid / g.nwy;

    // B's window token (by, bx) is pixel (wy ws + s + by, wx ws + s + bx)
    // of block A's frame, which reads x[(i - dc1) mod H, (j - dc1) mod W];
    // A window qd (wy + qd / 2, wx + qd % 2, modulo the counts) lands in G
    // (qd even) or Y (odd), the next one's rows in flight while one is
    // normalized, multiplied and attended
    auto gather_a = [&](int qd) {
      const int ay = (wy + qd / 2) % g.nwy, ax = (wx + qd % 2) % g.nwx;
      gather64(qd % 2 ? Y : G, g.ldx, n, C, x, [&](int t) {
        const int i = pmod(ay * ws + t / ws - g.dc1, g.H);
        const int j = pmod(ax * ws + t % ws - g.dc1, g.W);
        return x + ((b * g.H + i) * g.W + j) * C;
      });
    };
    gather64(X, g.ldx, n, C, x, [&](int r) {
      const int i = pmod(wy * ws + s + r / ws - g.dc1, g.H);
      const int j = pmod(wx * ws + s + r % ws - g.dc1, g.W);
      return x + ((b * g.H + i) * g.W + j) * C;
    });
    gather_a(0);
    cp_async_wait<1>();
    __syncthreads();
    // B's bank entry, by the window's last row and column in the output
    // frame
    const int sel = (wy == g.nwy - 1) * 2 + (wx == g.nwx - 1);
    const float* mk = bank != nullptr && !((g.bank_zero >> sel) & 1)
                          ? bank + static_cast<long long>(sel) * n * n
                          : nullptr;
    // block A, then block B: one code path, so each phase is compiled once
#pragma unroll 1
    for (int blk = 0; blk < 2; ++blk) {
      const PairW& w = ws2[blk];
      // LN1 and q of B's window's tokens in X: A's rows at their places in
      // its four windows (every quarter at once), then A's output for B
      ln_rows64([&](int r) { return r < n ? X + r * g.ldx : nullptr; }, C,
                w.ln1, Y, g.ldx);
      __syncthreads();
      {
        float acc[NQW / 2];
        pass<NQW>(acc, Y, g.ldx, g.kp, g.nq, wg * NQW, rg, false);
        store_bias<NQW>(acc, wg * NQW, w.bq, Q, g.ldq);
      }
      __syncthreads();
      if (blk == 0) gather_a(1);
      // k and v: A's on each of its four windows (LN1 in place first), B's
      // on the LN rows of its own; then the attention tasks: A's, a head
      // each of the quarter's 16 queries; B's, (16-row block, head)
#pragma unroll 1
      for (int qd = 0; qd < (blk ? 1 : 4); ++qd) {
        __nv_bfloat16* A = qd % 2 ? G : Y;
        if (blk == 0) {
          A = qd % 2 ? Y : G;
          if (qd < 3)
            cp_async_wait<1>();  // window qd's rows (qd + 1's may fly)
          else
            cp_async_wait<0>();
          __syncthreads();
          ln_rows64([&](int t) { return t < n ? A + t * g.ldx : nullptr; },
                    C, wa.ln1, A, g.ldx);
          __syncthreads();
        }
        kv_passes<NQW>(g, w, rg, A, KV);
        __syncthreads();
        if (blk == 0 && qd + 2 < 4) gather_a(qd + 2);  // where kv just read
        const int g8 = lane >> 2, qy = qd / 2, qx = qd % 2;
#pragma unroll 1
        for (int task = warp; task < (blk ? 4 : 1) * g.heads;
             task += P_NT / 32) {
          const int rb = blk ? task / g.heads : 0;
          const int h = blk ? task % g.heads : task;
          int qrow[2], brow[2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int i = 16 * rb + g8 + 8 * u;
            if (blk) {
              qrow[u] = i < n ? i : -1;
              brow[u] = i < n ? i : 0;
            } else {
              // query i of the quarter: B token (qy s + i / s, qx s + i %
              // s), at ((by + s) mod ws, (bx + s) mod ws) of the A window
              const int by = qy * s + i / s, bx = qx * s + i % s;
              const bool on = i < s * s;
              qrow[u] = on ? by * ws + bx : -1;
              brow[u] = on ? ((by + s) % ws) * ws + (bx + s) % ws : 0;
            }
          }
          if (16 * rb < n)
            attn16<KD>(Q, g.ldq, qrow, brow, KV, g.ldkv, g.nq, h, n, w.rpb,
                       blk ? mk : nullptr);
        }
        __syncthreads();
      }
      // proj + residual, LN2, fc1, fc2: A's output, cast to the canvas
      // dtype, is B's input tile; B's goes to the output frame
      proj_mlp64<NCW, NHW>(
          g, w, rg, Q, X, Y, KV, red, [&](int r, int c, float v0, float v1) {
            if (blk == 0) {
              *reinterpret_cast<uint32_t*>(X + r * g.ldx + c) =
                  pack_bf16(v0, v1);
            } else if (r < n) {
              const long long o =
                  (b * g.H + wy * ws + r / ws) * g.W + wx * ws + r % ws;
              *reinterpret_cast<uint32_t*>(out + o * C + c) =
                  pack_bf16(v0, v1);
            }
          });
      __syncthreads();
    }
  }
}

// ---------------------------------------------------------------------------
// float32 on Hopper (swin_pair_tf32_kernel): see the note at the top of the
// file.

constexpr int F_NT = 256;  // eight warps, one block an SM

// one block's float32 weights (ops/swin_block.py:swin_pair_f32_weights), in
// the order of the pointer array: each (K, N) weight split into TF32 parts
// and packed as mma.sync B fragments (uint4 {wh(k t), wh(k t + 4), wl(k
// t), wl(k t + 4)} of column 8 j + g, lane g * 4 + t, for n-tile j and k8
// step kk at ((j * K / 8) + kk) * 32 + lane)
struct PairWF {
  const uint4 *wq, *wkv, *wproj, *w1, *w2;
  const float *bq, *bkv, *bproj, *b1, *b2, *ln1, *ln2, *rpb;
};

struct FGeo {
  int B, H, W, C, heads, hdp, ws, dc1, nwy, nwx, n;
  int kp;   // C padded to 8: LN rows, proj's and fc2's columns
  int nq;   // heads x hdp: q; the attention output; proj's K
  int grp;  // heads a k / v group (2 grp hdp columns of R)
  int hc;   // fc1's columns a chunk (= nq): fc2's K a chunk
  int hidp; // hid padded to hc
  int ldx, ldq, ldr;  // pitches (floats) of X and Y, Q and H, R
  int vec;  // C % 4 == 0 and x 16-byte aligned: rows by 16-byte cp.async
  int bank_zero;
};

PairWF pair_wf(const void* const* p) {
  PairWF w;
  w.wq = static_cast<const uint4*>(p[0]);
  w.wkv = static_cast<const uint4*>(p[1]);
  w.wproj = static_cast<const uint4*>(p[2]);
  w.w1 = static_cast<const uint4*>(p[3]);
  w.w2 = static_cast<const uint4*>(p[4]);
  w.bq = static_cast<const float*>(p[5]);
  w.bkv = static_cast<const float*>(p[6]);
  w.bproj = static_cast<const float*>(p[7]);
  w.b1 = static_cast<const float*>(p[8]);
  w.b2 = static_cast<const float*>(p[9]);
  w.ln1 = static_cast<const float*>(p[10]);
  w.ln2 = static_cast<const float*>(p[11]);
  w.rpb = static_cast<const float*>(p[12]);
  return w;
}

// shared memory (floats): X (B's window, then A's output), Y (LN rows, A's
// windows gathered), Q (q, the attention output; fc1's chunk H), R (a
// head group's k | v; x1)
__host__ __device__ inline size_t pair_f32_smem(const FGeo& g) {
  return 64 * 4 * static_cast<size_t>(2 * g.ldx + g.ldq + g.ldr);
}

// C (64 x N) = A (64 x K, float32 row-major in shared memory, pitch lda, a
// multiple of 4 and odd in 16-byte units: the ldmatrix rows hit every bank
// once) . the packed weight Wp's n-tiles [nt0, nt1) and k8 steps [k08, k08
// + K / 8) (kst8: Wp's k8 steps an n-tile), in split TF32 on mma.sync
// m16n8k8: a warp a run of three n-tiles, all four 16-row blocks, A's
// fragments by ldmatrix and split in registers, the weights' fragments
// from L2 one k8 step ahead; epi(r, c, v0, v1) for columns c, c + 1 of row
// r. The caller syncs.
template <typename Epi>
__device__ __forceinline__ void gemm64(const float* A, int lda, int K,
                                       const uint4* __restrict__ Wp, int kst8,
                                       int k08, int nt0, int nt1, Epi epi) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3, k8 = K / 8;
  const float* arow = A + frag_row(lane) * lda + 4 * frag_khalf(lane);
#pragma unroll 1
  for (int j0 = nt0 + 3 * warp; j0 < nt1; j0 += 3 * (F_NT / 32)) {
    const int nj = nt1 - j0 < 3 ? nt1 - j0 : 3;
    const uint4* wp[3];
#pragma unroll
    for (int j = 0; j < 3; ++j)
      wp[j] = Wp + (static_cast<long long>(j < nj ? j0 + j : j0) * kst8 +
                    k08) * 32 + lane;
    float acc[4][3][4];
#pragma unroll
    for (int rb = 0; rb < 4; ++rb)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        acc[rb][j][0] = acc[rb][j][1] = acc[rb][j][2] = acc[rb][j][3] = 0.f;
    uint4 bn[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) bn[j] = __ldg(wp[j]);
#pragma unroll 1
    for (int kk = 0; kk < k8; ++kk) {
      uint4 bw[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        bw[j] = bn[j];
        if (kk + 1 < k8) bn[j] = __ldg(wp[j] + (kk + 1) * 32);
      }
      uint32_t ah[4][4], al[4][4];
#pragma unroll
      for (int rb = 0; rb < 4; ++rb) {
        uint32_t raw[4];
        ldmatrix_x4(raw, arow + 16 * rb * lda + 8 * kk);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          split1(__uint_as_float(raw[i]), ah[rb][i], al[rb][i]);
      }
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        if (j >= nj) continue;
#pragma unroll
        for (int rb = 0; rb < 4; ++rb) {
          mma_tf32(acc[rb][j], al[rb], bw[j].x, bw[j].y);
          mma_tf32(acc[rb][j], ah[rb], bw[j].z, bw[j].w);
          mma_tf32(acc[rb][j], ah[rb], bw[j].x, bw[j].y);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      if (j >= nj) continue;
#pragma unroll
      for (int rb = 0; rb < 4; ++rb)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          epi(16 * rb + g + 8 * h, 8 * (j0 + j) + 2 * t, acc[rb][j][2 * h],
              acc[rb][j][2 * h + 1]);
    }
  }
}

// rows r < n of the canvas (src(r): C floats of a pixel) into dst (pitch
// ld) by cp.async (16 bytes where vec, else 4), a warp a row; rows past n
// zero. The caller waits and syncs.
template <typename Src>
__device__ __forceinline__ void gather_f32(float* dst, int ld, int n, int C,
                                           int vec, Src src) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll 1
  for (int r = warp; r < 64; r += F_NT / 32) {
    float* dp = dst + r * ld;
    if (r >= n) {
      for (int c = lane; c < C; c += 32) dp[c] = 0.f;
      continue;
    }
    const float* sp = src(r);
    if (vec)
      for (int c = 4 * lane; c < C; c += 128) cp_async16(dp + c, sp + c);
    else
      for (int c = lane; c < C; c += 32) cp_async4(dp + c, sp + c);
  }
  cp_async_commit();
}

// LayerNorm (float32 two-pass statistics, eps 1e-5) of 64 rows src(r) (C
// floats, nullptr: a zero row) into Y (pitch ld, columns C .. kp zero), a
// warp a row; src(r) may be Y's own row r. The caller syncs.
template <typename Src>
__device__ __forceinline__ void ln_f32(Src src, int C, int kp,
                                       const float* __restrict__ lnp,
                                       float* Y, int ld) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll 1
  for (int r = warp; r < 64; r += F_NT / 32) {
    const float* p = src(r);
    float* yr = Y + r * ld;
    if (p == nullptr) {  // uniform across the warp
      for (int k = lane; k < kp; k += 32) yr[k] = 0.f;
      continue;
    }
    float s = 0.f;
    for (int k = lane; k < C; k += 32) s += p[k];
    const float mu = warp_sum(s) / C;
    float v = 0.f;
    for (int k = lane; k < C; k += 32) {
      const float d = p[k] - mu;
      v += d * d;
    }
    const float rs = rsqrtf(warp_sum(v) / C + 1e-5f);
    __syncwarp();  // every lane has read the row before any lane writes it
    for (int k = lane; k < kp; k += 32)
      yr[k] = k < C ? (p[k] - mu) * rs * lnp[k] + lnp[C + k] : 0.f;
  }
}

// One warp's attention task in float32: 16 query rows of one head (query
// i of the task in row qrow[i] of Q, -1 where it has none; bias row
// brow[i] of the head's rpb), against the n keys and values of R (k at
// column kc, v at vc of each token row): split TF32 on mma.sync m16n8k8,
// q and p split in registers, k and v split as they are read; (q.k + rpb
// (+ mask)) * log2 e, exp2(min(l, 86.56)), a reciprocal normalization; p
// passed from the logits' layout to PV's A fragments by shuffles. The
// output overwrites the task's q in Q (each task reads its q before it
// writes).
__device__ __forceinline__ void attn_tf32(float* Q, int ldq, int qc,
                                          const int (&qrow)[2],
                                          const int (&brow)[2],
                                          const float* R, int ldr, int kc,
                                          int vc, int hdp, int n,
                                          const float* __restrict__ rpb,
                                          const float* __restrict__ mask) {
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const float* q0 = Q + (qrow[0] < 0 ? 0 : qrow[0]) * ldq + qc;
  const float* q1 = Q + (qrow[1] < 0 ? 0 : qrow[1]) * ldq + qc;
  float s[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll 1
  for (int kd = 0; kd < hdp; kd += 8) {
    uint32_t ah[4], al[4];
    split_a(q0[kd + t], q1[kd + t], q0[kd + t + 4], q1[kd + t + 4], ah, al);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      if (8 * nt >= n) continue;
      const float* kr = R + (8 * nt + g) * ldr + kc + kd;
      mma_split(s[nt], ah, al, kr[t], kr[t + 4]);
    }
  }
  const float* b0 = rpb + brow[0] * n;
  const float* b1 = rpb + brow[1] * n;
  const float* m0 = mask != nullptr ? mask + brow[0] * n : nullptr;
  const float* m1 = mask != nullptr ? mask + brow[1] * n : nullptr;
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int j = 8 * nt + 2 * t;
    float2 c0 = make_float2(0.f, 0.f), c1 = c0;
    if (j < n) {  // n even: j + 1 < n too
      float2 p0 = ldg2(b0 + j), p1 = ldg2(b1 + j);
      if (m0 != nullptr) {
        const float2 k0 = ldg2(m0 + j), k1 = ldg2(m1 + j);
        p0.x += k0.x, p0.y += k0.y, p1.x += k1.x, p1.y += k1.y;
      }
      c0 = make_float2(exp2f(fminf((s[nt][0] + p0.x) * LOG2E, P_CLAMP)),
                       exp2f(fminf((s[nt][1] + p0.y) * LOG2E, P_CLAMP)));
      c1 = make_float2(exp2f(fminf((s[nt][2] + p1.x) * LOG2E, P_CLAMP)),
                       exp2f(fminf((s[nt][3] + p1.y) * LOG2E, P_CLAMP)));
    }
    s[nt][0] = c0.x, s[nt][1] = c0.y, s[nt][2] = c1.x, s[nt][3] = c1.y;
    s0 += c0.x + c0.y;
    s1 += c1.x + c1.y;
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    s0 += __shfl_xor_sync(0xffffffffu, s0, o);
    s1 += __shfl_xor_sync(0xffffffffu, s1, o);
  }
  const float i0 = 1.f / s0, i1 = 1.f / s1;
  // p (row g, column 8 kk + t) sits in lane (g, t / 2), element t % 2 of
  // the logits' n-tile kk; column 8 kk + t + 4 in lane (g, 2 + t / 2)
  const int la = (lane & ~3) | (t >> 1), lb = la + 2;
  const bool odd = t & 1;
  float o[8][4];
#pragma unroll
  for (int nd = 0; nd < 8; ++nd) o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    if (8 * kk >= n) continue;
    float e[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      e[i] = __shfl_sync(0xffffffffu, s[kk][i], la);
      e[4 + i] = __shfl_sync(0xffffffffu, s[kk][i], lb);
    }
    uint32_t ah[4], al[4];
    split_a((odd ? e[1] : e[0]) * i0, (odd ? e[3] : e[2]) * i1,
            (odd ? e[5] : e[4]) * i0, (odd ? e[7] : e[6]) * i1, ah, al);
    const float* vr0 = R + (8 * kk + t) * ldr + vc + g;
    const float* vr1 = vr0 + 4 * ldr;
#pragma unroll
    for (int nd = 0; nd < 8; ++nd)
      if (8 * nd < hdp) mma_split(o[nd], ah, al, vr0[8 * nd], vr1[8 * nd]);
  }
  __syncwarp();  // every lane's q is read before any lane writes
#pragma unroll
  for (int nd = 0; nd < 8; ++nd) {
    if (8 * nd >= hdp) continue;
    const int c = qc + 8 * nd + 2 * t;
    if (qrow[0] >= 0)
      *reinterpret_cast<float2*>(Q + qrow[0] * ldq + c) =
          make_float2(o[nd][0], o[nd][1]);
    if (qrow[1] >= 0)
      *reinterpret_cast<float2*>(Q + qrow[1] * ldq + c) =
          make_float2(o[nd][2], o[nd][3]);
  }
}

__device__ __forceinline__ float gelu_tanh(float v) {
  return 0.5f * v * (1.f + tanhf(0.7978845608f * (v + 0.044715f * v * v * v)));
}

__global__ void __launch_bounds__(F_NT, 1) swin_pair_tf32_kernel(
    const float* __restrict__ x, float* __restrict__ out, PairWF wa,
    PairWF wb, const float* __restrict__ bank, FGeo g) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* X = reinterpret_cast<float*>(smem);
  float* Y = X + 64 * g.ldx;
  float* Q = Y + 64 * g.ldx;
  float* R = Q + 64 * g.ldq;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ws = g.ws, s = ws / 2, n = g.n, C = g.C, hdp = g.hdp;
  long long bid = blockIdx.x;
  const int wx = static_cast<int>(bid % g.nwx);
  bid /= g.nwx;
  const int wy = static_cast<int>(bid % g.nwy);
  const long long b = bid / g.nwy;
  const int gw = 2 * g.grp * hdp;  // R's columns a head group
  const int ngrp = g.heads / g.grp;

  // B's window token (by, bx) is pixel (wy ws + s + by, wx ws + s + bx) of
  // block A's frame, which reads x[(i - dc1) mod H, (j - dc1) mod W]
  gather_f32(X, g.ldx, n, C, g.vec, [&](int r) {
    const int i = pmod(wy * ws + s + r / ws - g.dc1, g.H);
    const int j = pmod(wx * ws + s + r % ws - g.dc1, g.W);
    return x + ((b * g.H + i) * g.W + j) * C;
  });
  cp_async_wait<0>();
  __syncthreads();
  const int sel = (wy == g.nwy - 1) * 2 + (wx == g.nwx - 1);
  const float* mk = bank != nullptr && !((g.bank_zero >> sel) & 1)
                        ? bank + static_cast<long long>(sel) * n * n
                        : nullptr;
#pragma unroll 1
  for (int blk = 0; blk < 2; ++blk) {
    const PairWF& w = blk ? wb : wa;
    // LN1 and q of the window's tokens in X (block A: B's window, every
    // quarter at once)
    ln_f32([&](int r) { return r < n ? X + r * g.ldx : nullptr; }, C, g.kp,
           w.ln1, Y, g.ldx);
    __syncthreads();
    gemm64(Y, g.ldx, g.kp, w.wq, g.kp / 8, 0, 0, g.nq / 8,
           [&](int r, int c, float v0, float v1) {
             const float2 bb = ldg2(w.bq + c);
             *reinterpret_cast<float2*>(Q + r * g.ldq + c) =
                 make_float2(v0 + bb.x, v1 + bb.y);
           });
    __syncthreads();
    // k and v: A's on each of its four windows (gathered into Y, LN1 in
    // place), B's on the LN rows of its own; a head group at a time, then
    // that group's attention tasks: A's, a head each of the quarter's
    // queries; B's, (16-row block, head)
#pragma unroll 1
    for (int qd = 0; qd < (blk ? 1 : 4); ++qd) {
      const int qy = qd / 2, qx = qd % 2;
      if (blk == 0) {
        const int ay = (wy + qy) % g.nwy, ax = (wx + qx) % g.nwx;
        gather_f32(Y, g.ldx, n, C, g.vec, [&](int t) {
          const int i = pmod(ay * ws + t / ws - g.dc1, g.H);
          const int j = pmod(ax * ws + t % ws - g.dc1, g.W);
          return x + ((b * g.H + i) * g.W + j) * C;
        });
        cp_async_wait<0>();
        __syncthreads();
        ln_f32([&](int t) { return t < n ? Y + t * g.ldx : nullptr; }, C,
               g.kp, w.ln1, Y, g.ldx);
        __syncthreads();
      }
#pragma unroll 1
      for (int gi = 0; gi < ngrp; ++gi) {
        gemm64(Y, g.ldx, g.kp, w.wkv, g.kp / 8, 0, gi * gw / 8,
               (gi + 1) * gw / 8, [&](int r, int c, float v0, float v1) {
                 const float2 bb = ldg2(w.bkv + c);
                 *reinterpret_cast<float2*>(R + r * g.ldr + c - gi * gw) =
                     make_float2(v0 + bb.x, v1 + bb.y);
               });
        __syncthreads();
        const int nrb = blk ? (n + 15) / 16 : 1;
#pragma unroll 1
        for (int task = warp; task < nrb * g.grp; task += F_NT / 32) {
          const int rb = task / g.grp, hl = task % g.grp;
          const int h = gi * g.grp + hl;
          int qrow[2], brow[2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int i = 16 * rb + (lane >> 2) + 8 * u;
            if (blk) {
              qrow[u] = i < n ? i : -1;
              brow[u] = i < n ? i : 0;
            } else {
              // query i of the quarter: B token (qy s + i / s, qx s + i %
              // s), at ((by + s) mod ws, (bx + s) mod ws) of the A window
              const int by = qy * s + i / s, bx = qx * s + i % s;
              const bool on = i < s * s;
              qrow[u] = on ? by * ws + bx : -1;
              brow[u] = on ? ((by + s) % ws) * ws + (bx + s) % ws : 0;
            }
          }
          attn_tf32(Q, g.ldq, h * hdp, qrow, brow, R, g.ldr, hl * hdp,
                    g.grp * hdp + hl * hdp, hdp, n,
                    w.rpb + static_cast<long long>(h) * n * n,
                    blk ? mk : nullptr);
        }
        __syncthreads();
      }
    }
    // proj + bias + residual into x1 (R), LN2 into Y, then the MLP a
    // chunk of hc hidden channels at a time: fc1 + tanh-GELU into H (Q's
    // place), fc2's partial added onto x1 in float32
    float* x1 = R;
    float* Hc = Q;
    gemm64(Q, g.ldq, g.nq, w.wproj, g.nq / 8, 0, 0, g.kp / 8,
           [&](int r, int c, float v0, float v1) {
             float2 v = make_float2(0.f, 0.f);
             if (c < C) {  // C even: c + 1 < C too
               const float2 bb = ldg2(w.bproj + c);
               const float2 res =
                   *reinterpret_cast<const float2*>(X + r * g.ldx + c);
               v = make_float2(v0 + bb.x + res.x, v1 + bb.y + res.y);
             }
             *reinterpret_cast<float2*>(x1 + r * g.ldr + c) = v;
           });
    __syncthreads();
    ln_f32([&](int r) { return r < n ? x1 + r * g.ldr : nullptr; }, C, g.kp,
           w.ln2, Y, g.ldx);
    __syncthreads();
#pragma unroll 1
    for (int h0 = 0; h0 < g.hidp; h0 += g.hc) {
      gemm64(Y, g.ldx, g.kp, w.w1, g.kp / 8, 0, h0 / 8, (h0 + g.hc) / 8,
             [&](int r, int c, float v0, float v1) {
               const float2 bb = ldg2(w.b1 + c);
               *reinterpret_cast<float2*>(Hc + r * g.ldq + c - h0) =
                   make_float2(gelu_tanh(v0 + bb.x), gelu_tanh(v1 + bb.y));
             });
      __syncthreads();
      gemm64(Hc, g.ldq, g.hc, w.w2, g.hidp / 8, h0 / 8, 0, g.kp / 8,
             [&](int r, int c, float v0, float v1) {
               if (c >= C) return;
               float2* p = reinterpret_cast<float2*>(x1 + r * g.ldr + c);
               const float2 a = *p;
               *p = make_float2(a.x + v0, a.y + v1);
             });
      __syncthreads();
    }
    // A's output is B's input tile (X); B's goes to the output frame
    for (int e = tid; e < n * (C / 2); e += F_NT) {
      const int r = e / (C / 2), c = 2 * (e % (C / 2));
      const float2 a = *reinterpret_cast<const float2*>(x1 + r * g.ldr + c);
      const float2 bb = ldg2(w.b2 + c);
      const float2 v = make_float2(a.x + bb.x, a.y + bb.y);
      if (blk == 0) {
        *reinterpret_cast<float2*>(X + r * g.ldx + c) = v;
      } else {
        const long long o =
            (b * g.H + wy * ws + r / ws) * g.W + wx * ws + r % ws;
        *reinterpret_cast<float2*>(out + o * C + c) = v;
      }
    }
    __syncthreads();
  }
}

}  // namespace

// float32: pa, pb: 13 device pointers each (ops/swin_block.py:
// swin_pair_f32_weights); bank as the bf16 entry's; hdp (a multiple of 8,
// at most 64), kp, nq, grp, hc, hidp the form's widths (pair_f32_dims). N
// = ws^2 <= 64, ws even, C even, an even window count per row (the wrapper
// checks); the shared memory a block needs must fit the card's 227 KB.
extern "C" int swin_pair(const void* x, void* out, const void* const* pa,
                         const void* const* pb, const void* bank,
                         int bank_zero, int B, int H, int W, int C,
                         int heads, int hdp, int ws, int dc1, int kp, int nq,
                         int grp, int hc, int hidp, int vec, void* stream) {
  FGeo g;
  g.B = B, g.H = H, g.W = W, g.C = C, g.heads = heads, g.hdp = hdp;
  g.ws = ws, g.dc1 = dc1, g.nwy = H / ws, g.nwx = W / ws, g.n = ws * ws;
  g.kp = kp, g.nq = nq, g.grp = grp, g.hc = hc, g.hidp = hidp;
  g.ldx = kp + 4, g.ldq = nq + 4;
  g.ldr = (2 * grp * hdp > kp ? 2 * grp * hdp : kp) + 4;
  g.vec = vec, g.bank_zero = bank_zero;
  if (g.n > 64 || ws % 2 || C % 2 || C > kp || kp % 8 || hdp % 8 ||
      hdp > 64 || nq != heads * hdp || grp < 1 || heads % grp || hc > nq ||
      hc % 8 || hidp % hc)
    return cudaErrorInvalidValue;
  const size_t smem = pair_f32_smem(g);
  if (smem > 232448) return cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      swin_pair_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  swin_pair_tf32_kernel<<<static_cast<unsigned>(static_cast<long long>(B) *
                                                g.nwy * g.nwx),
                          F_NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), pair_wf(pa),
      pair_wf(pb), static_cast<const float*>(bank), g);
  return static_cast<int>(cudaGetLastError());
}

// The (NQW, NCW, NHW, KD) the bf16 kernel is instantiated for
// (ops/swin_block.py:PAIR_SHAPES lists the same): C 180 with 6 heads
// (SwinIR-M, HAT), C 48 with 2 heads, C 60 with 6 heads (SwinIR's
// lightweight width).
#define IRK_PAIR_SHAPES(X) X(96, 96, 96, 2) X(32, 24, 32, 2) X(48, 32, 32, 1)

// bf16: pa, pb: 13 device pointers each (ops/swin_block.py:
// swin_pair_weights); bank as above, bank_zero its all-zero entries (bit
// 2 * is_last_row + is_last_col); kp, kq, nq, nc, nh the form's padded
// widths; grid the persistent blocks.
extern "C" int swin_pair_bf16(const void* x, void* out,
                              const void* const* pa, const void* const* pb,
                              const void* bank, int bank_zero, int B, int H,
                              int W, int C, int heads, int hdp, int ws,
                              int dc1, int kp, int kq, int nq, int nc, int nh,
                              int grid, void* stream) {
  PGeo g;
  g.B = B, g.H = H, g.W = W, g.C = C, g.heads = heads, g.hdp = hdp;
  g.ws = ws, g.dc1 = dc1, g.nwy = H / ws, g.nwx = W / ws, g.n = ws * ws;
  g.kp = kp, g.kq = kq, g.nq = nq, g.nc = nc, g.nh = nh;
  g.ldx = kp + 8, g.ldq = kq + 8;
  g.ldkv = (2 * nq > nh ? 2 * nq : nh) + 8;
  g.nwin = static_cast<long long>(B) * g.nwy * g.nwx;
  g.bank_zero = bank_zero;
  if (g.n > 64 || ws % 2 || C % 2 || C > 256 || C > kp || kp % 64 ||
      kq % 64 || nh % 64 || nq != heads * hdp || grid < 1)
    return cudaErrorInvalidValue;
  const size_t smem = pair_layout(g).total;
  if (smem > 232448 || pair_stages(g) > P_MAXSEQ)
    return cudaErrorInvalidValue;
  const PairW wa = pair_w(pa), wb = pair_w(pb);
  const float* bk = static_cast<const float*>(bank);
  auto launch = [&](auto kernel) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<grid, P_NT, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<__nv_bfloat16*>(out), wa, wb, bk, g);
    return static_cast<int>(cudaGetLastError());
  };
  auto fixed = [&](auto set) {  // the instantiation's widths are the form's
    PGeo f = g;
    set(f);
    return f.kp == kp && f.kq == kq && f.nq == nq && f.nc == nc &&
           f.nh == nh && f.hdp == hdp;
  };
#define IRK_CASE(q, c, h, kd)                                            \
  if (nq == 2 * (q) && nc == 2 * (c) && nh == 4 * (h) && hdp == 16 * (kd)) \
    return fixed(set_dims<q, c, h, kd>)                                   \
               ? launch(swin_pair_mma_kernel<q, c, h, kd>)                \
               : static_cast<int>(cudaErrorInvalidValue);
  IRK_PAIR_SHAPES(IRK_CASE)
#undef IRK_CASE
  return cudaErrorInvalidValue;
}

// The pass's own check (tests/test_torch_kernels.py): one warpgroup
// computes D (64 x NW, float32) = A (64 x K, bf16 row-major, pitch K + 8 in
// shared memory) x the columns [n0, n0 + NW) of a packed K x N weight
// (swin_pair_weights' pass form), streamed through the ring as the kernel
// streams it.
template <int NW>
__global__ void __launch_bounds__(128) pair_gemm_tile_kernel(
    const __nv_bfloat16* __restrict__ A, const __nv_bfloat16* __restrict__ Wp,
    float* __restrict__ D, int K, int N, int n0) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + P_STAGES;
  unsigned long long* seq = reinterpret_cast<unsigned long long*>(smem + 128);
  unsigned char* ring = smem + 256;
  __nv_bfloat16* As =
      reinterpret_cast<__nv_bfloat16*>(ring + P_STAGES * P_SLOT);
  const int tid = threadIdx.x, lda = K + 8, kc = stage_k(K, N);
  if (tid == 0) {
    for (int i = 0; i < P_STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4);
    }
    fence_barrier_init();
    for (int k0 = 0; k0 < K; k0 += kc)
      seq[k0 / kc] = seq_entry(Wp + static_cast<long long>(k0) * N,
                               static_cast<uint32_t>(kc) * N * 2);
  }
  for (int e = tid; e < 64 * K; e += 128) As[(e / K) * lda + e % K] = A[e];
  __syncthreads();
  Ring rg{ring, full, empty, seq, K / kc, 0, static_cast<uint32_t>(K / kc)};
  rg.start();
  float acc[NW / 2];
  pass<NW>(acc, As, lda, K, N, n0, rg, false);
  each_pair<NW>(acc, 0, [&](int r, int c, float v0, float v1) {
    D[r * NW + c] = v0;
    D[r * NW + c + 1] = v1;
  });
}

// K a multiple of 16 up to 256, NW one of the kernel's widths
extern "C" int pair_gemm_tile(const void* A, const void* Wp, void* D, int K,
                              int N, int n0, int nw, void* stream) {
  if (K % 16 || K > 256 || n0 % 8 || n0 + nw > N || N * 32 > P_SLOT)
    return cudaErrorInvalidValue;
  const size_t smem = 256 + P_STAGES * P_SLOT + 64 * (K + 8) * 2;
  auto launch = [&](auto kernel) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<1, 128, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(A),
        static_cast<const __nv_bfloat16*>(Wp), static_cast<float*>(D), K, N,
        n0);
    return static_cast<int>(cudaGetLastError());
  };
  switch (nw) {
#define IRK_CASE(w) \
  case w:           \
    return launch(pair_gemm_tile_kernel<w>);
    IRK_CASE(24) IRK_CASE(32) IRK_CASE(48) IRK_CASE(64) IRK_CASE(96)
    IRK_CASE(192)
#undef IRK_CASE
    default:
      return cudaErrorInvalidValue;
  }
}
