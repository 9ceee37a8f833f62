// K7: two chained SAME 3x3 convolutions in one launch,
//   y = conv3x3(act(conv3x3(x, w1) + b1), w2) + b2,
// replacing the TPU kernel
// image_restoration_agent_tpu/ops/conv3x3.py:conv3x3_pair_pallas. See
// ops/conv3x3.py:conv3x3_pair for the contract and cast points.
//
// What bounds it on the H100: at the x4 head's second stage (1104x3840,
// 64 -> 256 -> 12) the pair is 1.48e12 FLOP against 0.64 GB of bf16 input
// and output, so the tensor cores bound it (1.5 ms in bf16; 9.0 ms in f32 at
// three TF32 passes). Two K3 launches write the 2.17 GB intermediate u
// and read it back, and pad Cout 12 to 64. Here u never reaches device
// memory.
//
// bf16 (conv3x3_pair_mma_kernel, Hopper): persistent blocks of two
// warpgroups walk 6 x 62 output tiles.
//   - The tile's input halo (10 rows x 66 pixels, every input channel,
//     Cin <= 64) is staged once by 16-byte cp.async in the no-swizzle
//     K-major core-matrix layout [row][8-channel group][pixel][8]: the 64
//     pixels from any pixel on, at 8 channels, are then one wgmma A operand
//     by descriptor (rows 16 bytes apart, 8-channel groups 66 x 16 bytes
//     apart), so every tap (dy, dx) reads the halo in place.
//   - u is computed on the 8 x 64 ring-extended tile, 64 Cmid channels a
//     chunk: warpgroup w takes u rows 4w .. 4w + 3, four m64n64
//     accumulators, and for each 16-channel stage of w1 nine taps x four
//     rows of wgmma_ss. Its epilogue in registers: + b1, LeakyReLU, zero
//     wherever the u pixel lies outside the canvas (conv2's SAME padding,
//     at every width), the cast, into shared memory in the same layout
//     (66 pixels a row, the last two zero).
//   - conv2 reads u the same way: warpgroup w takes output rows 3w .. 3w +
//     2 as m64nNO accumulators (Cout padded to 8: 12 -> 16), kept in
//     registers across every Cmid chunk; output pixels 62 and 63 of a row
//     are computed from the zero pixels and dropped.
//   - Both weights stream through a ring of four 18 KB stages (sm90_gemm.cuh:
//     StageRing) by 1-D bulk copies from K3's packed form
//     (ops/conv3x3.py:conv3x3_pair_weights): per chunk, w1's 16-channel
//     stages of the chunk's 64 columns, then w2's rows of the chunk.
//   - The epilogue stores y from the conv2 accumulators: + b2, the cast.
// The recomputed ring costs (8 x 64) / (6 x 62) = 1.38 of conv1's work.
// float32 (conv3x3_pair_tf32_kernel, Hopper): split TF32 on wgmma
// m64nNk8 (sm90_gemm.cuh: wgmma_split), every product xl wh + xh wl + xh
// wh summed in float32, as K3's float32 kernel (conv3x3.cu:
// conv3x3_tf32_kernel) computes a conv.
//   - Tile: a block owns 6 x 30 output pixels (one tile, no persistent
//     loop); u is computed on the 8 x 32 ring (256 pixels: two m64 tiles a
//     warpgroup), the input staged on 10 x 34 pixels. In float32 neither
//     the bf16 tile's halo (169 KB) nor its u (135 KB) fits beside a ring,
//     so the halo streams 8 input channels a stage and is read again from
//     L2 for every Cmid chunk (8 x 34 x 10 x 64 x 4 bytes a tile and chunk).
//     The ring costs 256 / 180 = 1.42 of the output's conv1 work.
//   - Stages: per 64-channel Cmid chunk, Cin / 8 conv1 stages (the halo's 8
//     channels by 16-byte cp.async, zero off the canvas and past Cin; both
//     w1 parts, 9 taps x 8 x 64, by one bulk copy) and NO / 8 conv2 stages
//     (64 / NO 8-channel chunks of both w2 parts), each 36 KB of weights, in
//     a ring of three 47 KB slots (K3's pipeline: stage j + 2 is issued
//     while stage j's products run).
//   - Products: for each tap ldmatrix.x4 gathers each lane's pixel (any
//     pixel of the halo or of u, halves swizzled so the rows hit every bank
//     once), the fragment is split into TF32 hi and lo by integer ops
//     (common.cuh: split1), and three wgmma per tap take the weights by
//     descriptor: conv1 m64n64k8 on both u tiles, conv2 m64nNOk8 on the
//     output's three m64 tiles (two and one a warpgroup).
//   - Sums: each wait group's products (27 wgmma) start from zero and add
//     into a second set of float32 registers (the tensor cores' adds drift
//     by about an ulp of the partial each): conv1 per 8 input channels,
//     conv2 per conv2 stage, across all of Cmid.
//   - u = act(conv1 + b1), zero off the canvas, into shared memory (64 KB,
//     8-channel groups), never to device memory; y = conv2 + b2 from the
//     registers.
// What bounds it (float32): 3 x 1.48e12 TF32 FLOP at the head shape, 9.0 ms
// at 495 TFLOP/s, against 1.29 GB of input and output (0.39 ms); the ring's
// 1.42 and K3's wait-per-group pattern (the tensor pipe drains while the
// next fragments load) hold it further from that.
//
// Plain C interface for ctypes; each entry returns cudaGetLastError().

#include "common.cuh"
#include "sm90_gemm.cuh"

using namespace irk;

namespace {

// the offset of a region of `bytes` at `o`, which moves past it (128-byte
// aligned regions)
__host__ __device__ inline size_t take(size_t& o, size_t bytes) {
  const size_t at = o;
  o = (o + bytes + 127) / 128 * 128;
  return at;
}

// ---------------------------------------------------------------------------
// float32 on Hopper (conv3x3_pair_tf32_kernel): see the note at the top.

constexpr int T_NT = 256;               // two warpgroups
constexpr int T_TH = 6, T_TW = 30;      // output tile
constexpr int T_UW = T_TW + 2;          // u tile: 8 x 32 pixels, 4 x m64
constexpr int T_UPIX = (T_TH + 2) * T_UW;
constexpr int T_HW = T_TW + 4;          // input halo: 10 x 34 pixels
constexpr int T_HPIX = (T_TH + 4) * T_HW;
constexpr int T_OUT = T_TH * T_TW;      // 180 output pixels: 3 x m64
constexpr int T_MC = 64;                // Cmid channels a chunk (conv1's N)
constexpr int T_KC = 8;                 // channels a k8 step
constexpr int T_HALO = T_HPIX * T_KC * 4;          // one halo stage
constexpr int T_WST = 2 * 9 * T_KC * T_MC * 4;     // one weight stage
constexpr int T_SLOT = T_HALO + T_WST;
constexpr int T_STAGES = 3;
constexpr int T_UG = T_UPIX * T_KC * 4;            // u: one 8-channel group
constexpr int T_U = (T_MC / T_KC) * T_UG;
constexpr int T_SRC = (T_HPIX * 8 + 127) / 128 * 128;
constexpr int T_FIXED = 128 + T_SRC;    // barriers, the halo's sources
constexpr int T_SMEM = T_FIXED + T_U + T_STAGES * T_SLOT;
static_assert(T_UPIX == 4 * 64 && T_OUT <= 3 * 64, "tile");
static_assert(T_HALO % 128 == 0 && T_SLOT % 128 == 0 && T_U % 128 == 0,
              "alignment");

// byte offset of channel half `h` (4 floats) of pixel p in an 8-channel
// staged layout: the two halves swapped where (p >> 2) & 1, so the 8 rows
// of an ldmatrix hit every bank once
__device__ __forceinline__ uint32_t t_at(int p, int h) {
  return static_cast<uint32_t>(p * 32 + ((h ^ ((p >> 2) & 1)) << 4));
}

// a fragment of float32 bit patterns split into TF32 parts by integer ops
// (common.cuh: split1): hi rounded to TF32, lo = x - hi passed whole
__device__ __forceinline__ void split_frag(const uint32_t (&raw)[4],
                                           uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split1(__uint_as_float(raw[i]), hi[i], lo[i]);
}

// NO: Cout padded to 8, 16 or 32 (conv2's N); a conv2 stage holds 64 / NO
// 8-channel chunks of w2, so both weights' stages are T_WST bytes
template <int NO>
__global__ void __launch_bounds__(T_NT, 1) conv3x3_pair_tf32_kernel(
    const float* __restrict__ x, const float* __restrict__ w1,
    const float* __restrict__ b1, const float* __restrict__ w2,
    const float* __restrict__ b2, float* __restrict__ out, int H, int W,
    int cin, int nci, int nmc, int cout, int act, int vec) {
  constexpr int K2C = 64 / NO;          // 8-channel chunks a conv2 stage
  constexpr int N2 = 8 / K2C;           // conv2 stages a Cmid chunk
  constexpr int WTAP1 = T_KC * T_MC * 4;
  constexpr int WTAP2 = T_KC * NO * 4;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  long long* src_s = reinterpret_cast<long long*>(smem + 128);
  unsigned char* U = smem + T_FIXED;
  unsigned char* ring = U + T_U;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wg = warp / 4, wq = warp % 4, g = lane >> 2, t = lane & 3;
  const int ntx = (W + T_TW - 1) / T_TW, nty = (H + T_TH - 1) / T_TH;
  long long bid = blockIdx.x;
  const int x0 = static_cast<int>(bid % ntx) * T_TW;
  bid /= ntx;
  const int y0 = static_cast<int>(bid % nty) * T_TH;
  const long long b = bid / nty;
  const int spc = nci + N2, nst = nmc * spc;

  if (tid == 0) {
    for (int s = 0; s < T_STAGES; ++s) mbar_init(&bars[s], 1);
    fence_barrier_init();
  }
  // halo pixel (r, p) is (y0 - 2 + r, x0 - 2 + p), -1 off the canvas
  for (int e = tid; e < T_HPIX; e += T_NT) {
    const int y = y0 - 2 + e / T_HW, xx = x0 - 2 + e % T_HW;
    src_s[e] = y >= 0 && y < H && xx >= 0 && xx < W ? (b * H + y) * W + xx
                                                     : -1;
  }
  __syncthreads();

  // stage j of the tile: Cmid chunk j / spc; i = j % spc < nci: conv1's
  // input channels 8 i .. (the halo's and w1's), else conv2's chunks of w2
  auto load_w = [&](int j) {  // thread 0
    const int m = j / spc, i = j % spc, st = j % T_STAGES;
    const float* src =
        i < nci ? w1 + static_cast<long long>(m * nci + i) * (T_WST / 4)
                : w2 + static_cast<long long>(8 * m + (i - nci) * K2C) *
                           (2 * 9 * T_KC * NO);
    mbar_arrive_expect_tx(&bars[st], T_WST);
    bulk_g2s(ring + st * T_SLOT + T_HALO, src, T_WST, &bars[st]);
  };
  auto stage_halo = [&](int j) {
    const int i = j % spc;
    if (i >= nci) return;
    unsigned char* hs = ring + (j % T_STAGES) * T_SLOT;
    for (int e = tid; e < 2 * T_HPIX; e += T_NT) {
      const int pe = e >> 1, h = e & 1, ch = T_KC * i + 4 * h;
      unsigned char* dst = hs + t_at(pe, h);
      const long long s = src_s[pe];
      if (vec) {
        const bool in = s >= 0 && ch < cin;
        cp_async16z(dst, in ? x + s * cin + ch : x, in ? 16 : 0);
        continue;
      }
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (s >= 0)
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (ch + k < cin) v[k] = x[s * cin + ch + k];
      *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    }
  };
  for (int j = 0; j < T_STAGES - 1; ++j) {
    if (j < nst) {
      if (tid == 0) load_w(j);
      stage_halo(j);
    }
    cp_async_commit();
  }

  // this lane's ldmatrix rows: u pixel p = 64 (2 wg + i) + 16 wq +
  // frag_row (u row p / 32, column p % 32) for conv1; output pixel q =
  // 64 (2 wg + i) + 16 wq + frag_row (row q / 30, column q % 30; past 180
  // pixel 0, dropped) for conv2
  const int fr = 16 * wq + frag_row(lane), kh = frag_khalf(lane);
  int ubase[2], obase[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int p = 64 * (2 * wg + i) + fr;
    ubase[i] = (p / T_UW) * T_HW + p % T_UW;
    const int q = p < T_OUT ? p : 0;
    obase[i] = (q / T_TW) * T_UW + q % T_TW;
  }
  const int nout = wg == 0 ? 2 : 1;  // output m64 tiles of this warpgroup

  // Two-level sums, as K3's: each wait group's products accumulate from
  // zero in the wgmma registers and add into tot with one float32 add.
  float tot1[2][T_MC / 2], tot2[2][NO / 2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int k = 0; k < T_MC / 2; ++k) tot1[i][k] = 0.f;
#pragma unroll
    for (int k = 0; k < NO / 2; ++k) tot2[i][k] = 0.f;
  }
  uint32_t hi[9][4], lo[9][4];
  for (int j = 0; j < nst; ++j) {
    const int st = j % T_STAGES, m = j / spc, i = j % spc;
    cp_async_wait_upto(T_STAGES - 2);
    __syncthreads();  // stage j's halo visible; stage j - 1's slot free
    const int jn = j + T_STAGES - 1;
    if (jn < nst) {
      if (tid == 0) load_w(jn);
      stage_halo(jn);
    }
    cp_async_commit();
    mbar_wait(&bars[st], (j / T_STAGES) & 1);
    const unsigned char* hs = ring + st * T_SLOT;
    const unsigned char* wsg = hs + T_HALO;
    if (i < nci) {
      // conv1: u (+)= this stage's 8 input channels, 9 taps, both u tiles
#pragma unroll
      for (int ui = 0; ui < 2; ++ui) {
        float acc[T_MC / 2];
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const int pe = ubase[ui] + (tap / 3) * T_HW + tap % 3;
          uint32_t raw[4];
          ldmatrix_x4(raw, hs + t_at(pe, kh));
          split_frag(raw, hi[tap], lo[tap]);
        }
        wgmma_fence();
#pragma unroll
        for (int tap = 0; tap < 9; ++tap)
          wgmma_split<T_MC>(acc, hi[tap], lo[tap],
                            b_desc(wsg + tap * WTAP1, T_MC * 16),
                            b_desc(wsg + (9 + tap) * WTAP1, T_MC * 16), true,
                            true, tap > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(hi);
        fence_regs(lo);
#pragma unroll
        for (int k = 0; k < T_MC / 2; ++k) tot1[ui][k] += acc[k];
      }
      if (i == nci - 1) {
        // u = act(conv1 + b1), 0 off the canvas, into U; conv2 of the
        // previous chunk is done with it (every thread passed this stage's
        // barrier), and the next stage's barrier publishes it
#pragma unroll
        for (int ui = 0; ui < 2; ++ui)
#pragma unroll
          for (int jj = 0; jj < T_MC / 8; ++jj)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int p = 64 * (2 * wg + ui) + 16 * wq + g + 8 * h;
              const int y = y0 - 1 + p / T_UW, xx = x0 - 1 + p % T_UW;
              const bool on = y >= 0 && y < H && xx >= 0 && xx < W;
              const float2 bb = ldg2(b1 + m * T_MC + 8 * jj + 2 * t);
              float v0 = tot1[ui][4 * jj + 2 * h] + bb.x;
              float v1 = tot1[ui][4 * jj + 2 * h + 1] + bb.y;
              if (act == 1) {
                v0 = v0 >= 0.f ? v0 : 0.01f * v0;
                v1 = v1 >= 0.f ? v1 : 0.01f * v1;
              }
              *reinterpret_cast<float2*>(U + jj * T_UG + t_at(p, t >> 1) +
                                         (t & 1) * 8) =
                  on ? make_float2(v0, v1) : make_float2(0.f, 0.f);
              tot1[ui][4 * jj + 2 * h] = tot1[ui][4 * jj + 2 * h + 1] = 0.f;
            }
      }
    } else {
      // conv2: y (+)= this stage's K2C chunks of u, 9 taps each
#pragma unroll
      for (int oi = 0; oi < 2; ++oi) {
        if (oi >= nout) continue;
        float acc[NO / 2];
#pragma unroll 1
        for (int kk = 0; kk < K2C; ++kk) {
          const unsigned char* ug = U + ((i - nci) * K2C + kk) * T_UG;
#pragma unroll
          for (int tap = 0; tap < 9; ++tap) {
            const int pu = obase[oi] + (tap / 3) * T_UW + tap % 3;
            uint32_t raw[4];
            ldmatrix_x4(raw, ug + t_at(pu, kh));
            split_frag(raw, hi[tap], lo[tap]);
          }
          wgmma_fence();
#pragma unroll
          for (int tap = 0; tap < 9; ++tap)
            wgmma_split<NO>(acc, hi[tap], lo[tap],
                            b_desc(wsg + (18 * kk + tap) * WTAP2, NO * 16),
                            b_desc(wsg + (18 * kk + 9 + tap) * WTAP2,
                                   NO * 16),
                            true, true, kk > 0 || tap > 0);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(acc);
          fence_regs(hi);
          fence_regs(lo);
        }
#pragma unroll
        for (int k = 0; k < NO / 2; ++k) tot2[oi][k] += acc[k];
      }
    }
  }

  // y = conv2 + b2: output pixels past 180, rows past H, columns past W
  // and channels past Cout are dropped
#pragma unroll
  for (int oi = 0; oi < 2; ++oi) {
    if (oi >= nout) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = 64 * (2 * wg + oi) + 16 * wq + g + 8 * h;
      const int y = y0 + q / T_TW, xx = x0 + q % T_TW;
      if (q >= T_OUT || y >= H || xx >= W) continue;
      float* o = out + ((b * H + y) * W + xx) * cout;
#pragma unroll
      for (int jj = 0; jj < NO / 8; ++jj) {
        const int co = 8 * jj + 2 * t;
        if (co < cout) o[co] = tot2[oi][4 * jj + 2 * h] + b2[co];
        if (co + 1 < cout) o[co + 1] = tot2[oi][4 * jj + 2 * h + 1] + b2[co + 1];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 on Hopper (conv3x3_pair_mma_kernel): see the note at the top.

constexpr int Q_NT = 256;         // two warpgroups
constexpr int Q_TH = 6;           // output rows a tile (3 a warpgroup)
constexpr int Q_TW = 62;          // output columns a tile
constexpr int Q_UR = Q_TH + 2;    // u rows (4 a warpgroup)
constexpr int Q_HR = Q_TH + 4;    // input halo rows
constexpr int Q_PX = 66;          // halo and u pixels a row (u: 64 + 2 zero)
constexpr int Q_MC = 64;          // Cmid channels a chunk
constexpr int Q_SLOT = 9 * 16 * Q_MC * 2;  // a stage: 9 taps x 16 k x 64
constexpr int Q_STAGES = 4;
constexpr int Q_MAXSEQ = 64;      // stages a tile, at most
constexpr int Q_MAXC = 1024;      // Cmid, at most (its bias in shared memory)
constexpr int Q_ROWB = Q_PX * 16;  // bytes of one 8-channel group of a row

using QRing = StageRing<Q_STAGES, Q_SLOT>;

struct QLay {
  size_t bars, seq, bias, halo, u, ring, total;
};

// shared memory: barriers, the stage table, the biases, the halo (Q_HR rows
// x cinp / 8 groups), u (Q_UR rows x 8 groups), the ring
__host__ __device__ inline QLay q_layout(int cinp) {
  QLay l;
  size_t o = 0;
  l.bars = take(o, 2 * Q_STAGES * 8);
  l.seq = take(o, Q_MAXSEQ * 8);
  l.bias = take(o, (Q_MAXC + 32) * 4);
  l.halo = take(o, static_cast<size_t>(Q_HR) * (cinp / 8) * Q_ROWB);
  l.u = take(o, static_cast<size_t>(Q_UR) * (Q_MC / 8) * Q_ROWB);
  l.ring = take(o, static_cast<size_t>(Q_STAGES) * Q_SLOT);
  l.total = o;
  return l;
}

// conv2's k16 steps a stage (w2's rows of a chunk in stages of at most
// Q_SLOT bytes)
__host__ __device__ inline int q_ks2(int no) { return no <= 16 ? 4 : 2; }

// NO: Cout padded to 8 (the conv2 product's width)
template <int NO>
__global__ void __launch_bounds__(Q_NT, 1) conv3x3_pair_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w1,
    const float* __restrict__ b1, const __nv_bfloat16* __restrict__ w2,
    const float* __restrict__ b2, __nv_bfloat16* __restrict__ out, int B,
    int H, int W, int cin, int cinp, int cmidp, int cout, int act) {
  extern __shared__ __align__(128) unsigned char smem[];
  const QLay L = q_layout(cinp);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + Q_STAGES;
  unsigned long long* seq =
      reinterpret_cast<unsigned long long*>(smem + L.seq);
  float* b1s = reinterpret_cast<float*>(smem + L.bias);  // b1, then b2
  float* b2s = b1s + cmidp;
  unsigned char* halo = smem + L.halo;
  unsigned char* U = smem + L.u;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wg = warp / 4, wq = warp % 4, g = lane >> 2, t = lane & 3;
  const int cg = cinp / 8, nci = cinp / 16, nmc = cmidp / Q_MC;
  constexpr int KS2 = NO <= 16 ? 4 : 2;
  const int ntx = (W + Q_TW - 1) / Q_TW, nty = (H + Q_TH - 1) / Q_TH;
  const long long ntiles = static_cast<long long>(B) * nty * ntx;
  const long long nmine =
      blockIdx.x < ntiles ? (ntiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int nseq = nmc * (nci + 4 / KS2);

  if (tid == 0) {
    for (int i = 0; i < Q_STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], Q_NT / 32);
    }
    fence_barrier_init();
    // one tile's stages: per chunk, w1's 16-channel stages of its columns,
    // then w2's rows of the chunk
    int k = 0;
    for (int m = 0; m < nmc; ++m) {
      for (int c = 0; c < nci; ++c)
        seq[k++] = seq_entry(w1 + static_cast<long long>(m * nci + c) * 9 *
                                      16 * Q_MC,
                             Q_SLOT);
      for (int s = 0; s < 4 / KS2; ++s)
        seq[k++] = seq_entry(
            w2 + static_cast<long long>(4 * m + s * KS2) * 9 * 16 * NO,
            KS2 * 9 * 16 * NO * 2);
    }
  }
  for (int e = tid; e < cmidp + NO; e += Q_NT)
    b1s[e] = e < cmidp ? b1[e] : b2[e - cmidp];
  // u's last two pixels of every row and group stay zero
  for (int e = tid; e < Q_UR * (Q_MC / 8) * 2; e += Q_NT)
    *reinterpret_cast<uint4*>(U + (e / 2) * Q_ROWB + (64 + e % 2) * 16) =
        make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  QRing rg{smem + L.ring, full, empty, seq, nseq, 0,
           static_cast<uint32_t>(nmine * nseq)};
  rg.start();

  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    long long bid = tile;
    const int x0 = static_cast<int>(bid % ntx) * Q_TW;
    bid /= ntx;
    const int y0 = static_cast<int>(bid % nty) * Q_TH;
    const long long b = bid / nty;

    // the halo: pixel (r, p) is (y0 - 2 + r, x0 - 2 + p), 0 off the canvas
    // and past Cin
    for (int e = tid; e < Q_HR * cg * Q_PX; e += Q_NT) {
      const int p = e % Q_PX, rc = e / Q_PX, c = rc % cg, r = rc / cg;
      const int y = y0 - 2 + r, xx = x0 - 2 + p;
      const bool on = y >= 0 && y < H && xx >= 0 && xx < W;
      unsigned char* dst = halo + (rc * Q_PX + p) * 16;
      const __nv_bfloat16* src = x + ((b * H + y) * W + xx) * cin + 8 * c;
      if ((cin & 7) == 0) {
        cp_async16z(dst, on && 8 * c < cin ? src : x,
                    on && 8 * c < cin ? 16 : 0);
      } else {
        uint32_t v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int k0 = 8 * c + 2 * i;
          const __nv_bfloat16 z = __float2bfloat16_rn(0.f);
          v[i] = pack_bf16(on && k0 < cin ? src[2 * i] : z,
                           on && k0 + 1 < cin ? src[2 * i + 1] : z);
        }
        *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();

    float acc2[3][NO / 2];
    for (int m = 0; m < nmc; ++m) {
      // conv1: u rows 4 wg .. 4 wg + 3 of the chunk's 64 channels
      float acc1[4][32];
      for (int c = 0; c < nci; ++c) {
        const unsigned char* ws = rg.wait();
        wgmma_fence();
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const uint64_t bd = b_desc(ws + tap * Q_MC * 32, Q_MC * 16);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int hr = 4 * wg + i + tap / 3;
            wgmma_ss<64>(acc1[i],
                         b_desc(halo + ((hr * cg + 2 * c) * Q_PX + tap % 3) *
                                           16,
                                Q_ROWB),
                         bd, c > 0 || tap > 0);
          }
        }
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < 4; ++i) fence_regs(acc1[i]);
        rg.release();
      }
      __syncthreads();  // the previous chunk's conv2 is done with u
      // u = act(conv1 + b1), 0 off the canvas, cast, into U
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ur = 4 * wg + i, y = y0 - 1 + ur;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 bb =
              *reinterpret_cast<const float2*>(b1s + m * Q_MC + 8 * j + 2 * t);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int px = 16 * wq + g + 8 * h, xx = x0 - 1 + px;
            const bool on = y >= 0 && y < H && xx >= 0 && xx < W;
            float v0 = acc1[i][4 * j + 2 * h] + bb.x;
            float v1 = acc1[i][4 * j + 2 * h + 1] + bb.y;
            if (act == 1) {
              v0 = v0 >= 0.f ? v0 : 0.01f * v0;
              v1 = v1 >= 0.f ? v1 : 0.01f * v1;
            }
            *reinterpret_cast<uint32_t*>(
                U + ((ur * (Q_MC / 8) + j) * Q_PX + px) * 16 + 4 * t) =
                on ? pack_bf16(v0, v1) : 0u;
          }
        }
      }
      fence_proxy_async();
      __syncthreads();
      // conv2: output rows 3 wg .. 3 wg + 2, the chunk's 64 channels of K
      for (int s = 0; s < 4 / KS2; ++s) {
        const unsigned char* ws = rg.wait();
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < KS2; ++k) {
          const int grp = 2 * (s * KS2 + k);
#pragma unroll
          for (int tap = 0; tap < 9; ++tap) {
            const uint64_t bd = b_desc(ws + (k * 9 + tap) * NO * 32, NO * 16);
#pragma unroll
            for (int i = 0; i < 3; ++i) {
              const int ur = 3 * wg + i + tap / 3;
              wgmma_ss<NO>(acc2[i],
                           b_desc(U + ((ur * (Q_MC / 8) + grp) * Q_PX +
                                       tap % 3) *
                                          16,
                                  Q_ROWB),
                           bd, m > 0 || s > 0 || k > 0 || tap > 0);
            }
          }
        }
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < 3; ++i) fence_regs(acc2[i]);
        rg.release();
      }
    }
    // y = conv2 + b2, cast; pixels 62 and 63 of a row, rows past H,
    // columns past W and channels past Cout are dropped
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int y = y0 + 3 * wg + i;
#pragma unroll
      for (int j = 0; j < NO / 8; ++j) {
        const int co = 8 * j + 2 * t;
        if (co >= cout) continue;
        const float2 bb = *reinterpret_cast<const float2*>(b2s + co);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int px = 16 * wq + g + 8 * h, xx = x0 + px;
          if (px >= Q_TW || xx >= W || y >= H) continue;
          __nv_bfloat16* o = out + ((b * H + y) * W + xx) * cout + co;
          const float v0 = acc2[i][4 * j + 2 * h] + bb.x;
          const float v1 = acc2[i][4 * j + 2 * h + 1] + bb.y;
          if (co + 1 < cout && (cout & 1) == 0) {
            *reinterpret_cast<uint32_t*>(o) = pack_bf16(v0, v1);
          } else {
            o[0] = __float2bfloat16_rn(v0);
            if (co + 1 < cout) o[1] = __float2bfloat16_rn(v1);
          }
        }
      }
    }
  }
}

// The K7 product form's own check (tests/test_torch_kernels.py): one
// warpgroup computes D (64 x N, float32) = A[dx .. dx + 64) (A: 66 x K
// bf16, row-major, staged as the halo is, [8-channel group][pixel][8]) x B
// (a K x N kernel_matrix form, one k16 step N x 32 bytes), both by
// no-swizzle descriptor.
template <int N>
__global__ void __launch_bounds__(128) pair_conv_tile_kernel(
    const __nv_bfloat16* __restrict__ A, const __nv_bfloat16* __restrict__ Bp,
    float* __restrict__ D, int K, int dx) {
  __shared__ __align__(128) unsigned char sa[8 * Q_ROWB];
  __shared__ __align__(128) unsigned char sb[64 * 64 * 2];
  const int tid = threadIdx.x, wq = tid / 32, lane = tid % 32;
  for (int e = tid; e < Q_PX * K; e += 128) {
    const int p = e / K, k = e % K;
    reinterpret_cast<__nv_bfloat16*>(sa + ((k / 8) * Q_PX + p) * 16)[k % 8] =
        A[e];
  }
  for (int e = tid; e < K * N; e += 128)
    reinterpret_cast<__nv_bfloat16*>(sb)[e] = Bp[e];
  fence_proxy_async();
  __syncthreads();
  float acc[N / 2];
  wgmma_fence();
  for (int ks = 0; ks < K / 16; ++ks)
    wgmma_ss<N>(acc, b_desc(sa + ((2 * ks) * Q_PX + dx) * 16, Q_ROWB),
                b_desc(sb + ks * N * 32, N * 16), ks > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * wq + g + 8 * h, c = 8 * j + 2 * t;
      D[r * N + c] = acc[4 * j + 2 * h];
      D[r * N + c + 1] = acc[4 * j + 2 * h + 1];
    }
}

}  // namespace

// float32: w1, w2 the split-TF32 forms of ops/conv3x3.py:
// conv3x3_pair_weights (K3's float32 order, both parts: w1 in slices of 64
// columns, Cin padded to 8; w2 one slice of coutp columns, Cmid padded to
// 64), b1 and b2 padded to cmidp and coutp; coutp one of 8, 16, 32; vec: Cin
// % 4 == 0 and x 16-byte aligned (the halo by 16-byte cp.async)
extern "C" int conv3x3_pair(const void* x, const void* w1, const void* b1,
                            const void* w2, const void* b2, void* out, int B,
                            int H, int W, int cin, int cmidp, int cout,
                            int coutp, int act, int vec, void* stream) {
  if (cin < 1 || cin > 64 || cmidp % T_MC || cmidp < T_MC || cout > coutp)
    return cudaErrorInvalidValue;
  const long long nblk = static_cast<long long>(B) *
                         ((H + T_TH - 1) / T_TH) * ((W + T_TW - 1) / T_TW);
  auto launch = [&](auto kernel) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T_SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<static_cast<unsigned>(nblk), T_NT, T_SMEM,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(w1),
        static_cast<const float*>(b1), static_cast<const float*>(w2),
        static_cast<const float*>(b2), static_cast<float*>(out), H, W, cin,
        (cin + T_KC - 1) / T_KC, cmidp / T_MC, cout, act, vec);
    return static_cast<int>(cudaGetLastError());
  };
  switch (coutp) {
    case 8:
      return launch(conv3x3_pair_tf32_kernel<8>);
    case 16:
      return launch(conv3x3_pair_tf32_kernel<16>);
    case 32:
      return launch(conv3x3_pair_tf32_kernel<32>);
    default:
      return cudaErrorInvalidValue;
  }
}

// bf16: w1, w2 the packed forms of ops/conv3x3.py:conv3x3_pair_weights
// (K3's order: w1 in slices of 64 columns, Cin padded to 16; w2 one slice
// of coutp columns, Cmid padded to 64), b1 and b2 float32 padded to cmidp
// and coutp; coutp (Cout padded to 8) one of 8, 16, 24, 32; grid the
// persistent blocks.
extern "C" int conv3x3_pair_bf16(const void* x, const void* w1,
                                 const void* b1, const void* w2,
                                 const void* b2, void* out, int B, int H,
                                 int W, int cin, int cinp, int cmidp,
                                 int cout, int coutp, int act, int grid,
                                 void* stream) {
  if (cinp % 16 || cinp > 64 || cin > cinp || cmidp % Q_MC ||
      cmidp > Q_MAXC || cout > coutp ||
      grid < 1 ||
      (cmidp / Q_MC) * (cinp / 16 + 4 / q_ks2(coutp)) > Q_MAXSEQ)
    return cudaErrorInvalidValue;
  const size_t smem = q_layout(cinp).total;
  auto launch = [&](auto kernel) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<grid, Q_NT, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w1), static_cast<const float*>(b1),
        static_cast<const __nv_bfloat16*>(w2), static_cast<const float*>(b2),
        static_cast<__nv_bfloat16*>(out), B, H, W, cin, cinp, cmidp, cout,
        act);
    return static_cast<int>(cudaGetLastError());
  };
  switch (coutp) {
    case 8:
      return launch(conv3x3_pair_mma_kernel<8>);
    case 16:
      return launch(conv3x3_pair_mma_kernel<16>);
    case 24:
      return launch(conv3x3_pair_mma_kernel<24>);
    case 32:
      return launch(conv3x3_pair_mma_kernel<32>);
    default:
      return cudaErrorInvalidValue;
  }
}

// K a multiple of 16 up to 64, N one of 16, 64; dx 0 to 2
extern "C" int pair_conv_tile(const void* A, const void* Bp, void* D, int K,
                              int N, int dx, void* stream) {
  if (K % 16 || K < 16 || K > 64 || dx < 0 || dx > 2)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* a = static_cast<const __nv_bfloat16*>(A);
  const auto* b = static_cast<const __nv_bfloat16*>(Bp);
  float* d = static_cast<float*>(D);
  if (N == 16)
    pair_conv_tile_kernel<16><<<1, 128, 0, s>>>(a, b, d, K, dx);
  else if (N == 64)
    pair_conv_tile_kernel<64><<<1, 128, 0, s>>>(a, b, d, K, dx);
  else
    return cudaErrorInvalidValue;
  return static_cast<int>(cudaGetLastError());
}
