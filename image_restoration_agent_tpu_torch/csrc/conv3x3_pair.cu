// K7: two chained SAME 3x3 convolutions in one launch,
//   y = conv3x3(act(conv3x3(x, w1) + b1), w2) + b2,
// replacing the TPU kernel
// image_restoration_agent_tpu/ops/conv3x3.py:conv3x3_pair_pallas. See
// ops/conv3x3.py:conv3x3_pair for the contract and cast points.
//
// What bounds it on the H100: at the x4 head's second stage (1104x3840,
// 64 -> 256 -> 12) the pair is 1.48e12 FLOP against 0.64 GB of bf16 input
// and output, so the tensor cores bound it (1.5 ms in bf16; 22 ms on the
// FP32 pipes in f32). Two K3 launches write the 2.17 GB intermediate u
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
// f32 (conv3x3_pair_kernel): a block owns an 8 x 30 output tile, stages its
// 12 x 34 input tile once and walks Cmid in chunks of 16 on FP32 FMA (no
// TF32), u for each chunk on the 10 x 32 ring-extended tile in shared
// memory.
//
// Plain C interface for ctypes; each entry returns cudaGetLastError().

#include "common.cuh"
#include "sm90_gemm.cuh"

using namespace irk;

namespace {

constexpr int TH = 8;          // output rows per block
constexpr int TW = 30;         // output columns per block
constexpr int UH = TH + 2;     // u rows
constexpr int UW = TW + 2;     // u columns computed
constexpr int UWS = UW + 2;    // u columns stored: the last two stay zero
constexpr int IH = TH + 4;     // input rows
constexpr int IW = TW + 4;     // input columns
constexpr int NT = 256;
constexpr int MCF = 16;        // Cmid channels per chunk

__device__ __forceinline__ float act_fn(float v, int act) {
  return act == 1 ? (v >= 0.f ? v : 0.01f * v) : v;
}

struct PairLayout {
  size_t in, w1, u, w2, scr, total;
  int ldi, ldw1, ldu, ldw2;
};

// the offset of a region of `bytes` at `o`, which moves past it (128-byte
// aligned regions)
__host__ __device__ inline size_t take(size_t& o, size_t bytes) {
  const size_t at = o;
  o = (o + bytes + 127) / 128 * 128;
  return at;
}

__host__ __device__ inline PairLayout f32_layout(int cin, int cout) {
  PairLayout l;
  l.ldi = cin + 1;
  l.ldw1 = MCF;
  l.ldu = MCF + 1;
  l.ldw2 = cout;
  size_t o = 0;
  l.in = take(o, static_cast<size_t>(IH * IW) * l.ldi * 4);
  l.w1 = take(o, static_cast<size_t>(9 * cin) * MCF * 4);
  l.u = take(o, static_cast<size_t>(UH * UWS) * l.ldu * 4);
  l.w2 = take(o, static_cast<size_t>(9 * MCF) * cout * 4);
  l.scr = o;
  l.total = o;
  return l;
}

// block -> (batch, tile row origin, tile column origin)
__device__ __forceinline__ void tile_of(int H, int W, long long& b, int& y0,
                                        int& x0) {
  const int nty = (H + TH - 1) / TH, ntx = (W + TW - 1) / TW;
  long long bid = blockIdx.x;
  x0 = static_cast<int>(bid % ntx) * TW;
  bid /= ntx;
  y0 = static_cast<int>(bid % nty) * TH;
  b = bid / nty;
}

constexpr int NPF = UH * UW / (NT / MCF);  // u pixels per thread (f32): 20

__global__ void __launch_bounds__(NT) conv3x3_pair_kernel(
    const float* __restrict__ x, const float* __restrict__ w1,
    const float* __restrict__ b1, const float* __restrict__ w2,
    const float* __restrict__ b2, float* __restrict__ out, int H, int W,
    int cin, int cmid, int cout, int act) {
  extern __shared__ __align__(128) unsigned char smem[];
  const PairLayout L = f32_layout(cin, cout);
  float* In = reinterpret_cast<float*>(smem + L.in);
  float* W1s = reinterpret_cast<float*>(smem + L.w1);
  float* U = reinterpret_cast<float*>(smem + L.u);
  float* W2s = reinterpret_cast<float*>(smem + L.w2);
  const int tid = threadIdx.x;
  long long b;
  int y0, x0;
  tile_of(H, W, b, y0, x0);

  for (int e = tid; e < IH * IW * cin; e += NT) {
    const int p = e / cin, c = e % cin;
    const int y = y0 - 2 + p / IW, xx = x0 - 2 + p % IW;
    const bool in = y >= 0 && y < H && xx >= 0 && xx < W;
    In[p * L.ldi + c] = in ? x[((b * H + y) * W + xx) * cin + c] : 0.f;
  }
  for (int e = tid; e < UH * 2 * MCF; e += NT) {
    const int r = e / (2 * MCF), c = UW + (e / MCF) % 2, k = e % MCF;
    U[(r * UWS + c) * L.ldu + k] = 0.f;
  }

  // conv1 mapping: channel m of the chunk, pixels pg, pg + 16, ...
  const int m = tid % MCF, pg = tid / MCF;
  int ioff[NPF];
#pragma unroll
  for (int i = 0; i < NPF; ++i) {
    const int p = pg + (NT / MCF) * i;
    ioff[i] = ((p / UW) * IW + p % UW) * L.ldi;
  }
  // conv2 mapping: output channel co, output row r, every column
  const int co = tid % 32, r = tid / 32;
  float oacc[TW];
#pragma unroll
  for (int c = 0; c < TW; ++c) oacc[c] = 0.f;

  for (int mc0 = 0; mc0 < cmid; mc0 += MCF) {
    __syncthreads();
    for (int e = tid; e < 9 * cin * MCF; e += NT) {
      const int row = e / MCF, mm = e % MCF;
      W1s[e] = mc0 + mm < cmid
                   ? w1[static_cast<long long>(row) * cmid + mc0 + mm]
                   : 0.f;
    }
    for (int e = tid; e < 9 * MCF * cout; e += NT) {
      const int row = e / cout, c = e % cout;
      const int tap = row / MCF, k = row % MCF;
      W2s[e] = mc0 + k < cmid
                   ? w2[(static_cast<long long>(tap) * cmid + mc0 + k) * cout +
                        c]
                   : 0.f;
    }
    __syncthreads();

    float acc[NPF];
#pragma unroll
    for (int i = 0; i < NPF; ++i) acc[i] = 0.f;
    for (int tap = 0; tap < 9; ++tap) {
      const int toff = ((tap / 3) * IW + tap % 3) * L.ldi;
      const float* wr = W1s + tap * cin * MCF + m;
      for (int k = 0; k < cin; ++k) {
        const float wv = wr[k * MCF];
#pragma unroll
        for (int i = 0; i < NPF; ++i)
          acc[i] = fmaf(In[ioff[i] + toff + k], wv, acc[i]);
      }
    }
    const bool live = mc0 + m < cmid;
    const float bias = live ? b1[mc0 + m] : 0.f;
#pragma unroll
    for (int i = 0; i < NPF; ++i) {
      const int p = pg + (NT / MCF) * i;
      const int ur = p / UW, uc = p % UW;
      const int y = y0 - 1 + ur, xx = x0 - 1 + uc;
      float v = act_fn(acc[i] + bias, act);
      if (!live || y < 0 || y >= H || xx < 0 || xx >= W) v = 0.f;
      U[(ur * UWS + uc) * L.ldu + m] = v;
    }
    __syncthreads();

    if (co < cout) {
      for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3, dx = tap % 3;
        for (int k = 0; k < MCF; ++k) {
          const float wv = W2s[(tap * MCF + k) * cout + co];
          const float* up = U + ((r + dy) * UWS + dx) * L.ldu + k;
#pragma unroll
          for (int c = 0; c < TW; ++c)
            oacc[c] = fmaf(up[c * L.ldu], wv, oacc[c]);
        }
      }
    }
  }

  const int oy = y0 + r;
  if (co < cout && oy < H) {
#pragma unroll
    for (int c = 0; c < TW; ++c) {
      const int ox = x0 + c;
      if (ox < W) out[((b * H + oy) * W + ox) * cout + co] = oacc[c] + b2[co];
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

// 16 bytes global -> shared, zero-filled when `bytes` is 0
__device__ __forceinline__ void cp_async16z(void* smem, const void* gmem,
                                            int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes));
}

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

// f32: the weights HWIO, unpadded.
extern "C" int conv3x3_pair(const void* x, const void* w1, const void* b1,
                            const void* w2, const void* b2, void* out, int B,
                            int H, int W, int cin, int cmid, int cout,
                            int act, void* stream) {
  if (cin > 64 || cout > 32) return cudaErrorInvalidValue;
  const long long nblk = static_cast<long long>(B) * ((H + TH - 1) / TH) *
                         ((W + TW - 1) / TW);
  const size_t smem = f32_layout(cin, cout).total;
  const cudaError_t e = cudaFuncSetAttribute(
      conv3x3_pair_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  conv3x3_pair_kernel<<<static_cast<unsigned>(nblk), NT, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<float*>(out), H, W, cin,
      cmid, cout, act);
  return static_cast<int>(cudaGetLastError());
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
