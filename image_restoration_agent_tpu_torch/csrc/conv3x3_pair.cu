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
// memory:
//   - a block owns an 8 x 30 output tile; it stages the 12 x 34 input
//     tile (a 2-pixel halo, every input channel: Cin <= 64) in shared
//     memory once;
//   - it walks over Cmid in chunks (32 channels in bf16, 16 in f32): for
//     each chunk it computes u on the 10 x 32 ring-extended tile (float32
//     sums, + b1, the activation, the cast, and zero where the u pixel
//     lies outside the canvas: conv2's SAME padding) into shared memory,
//     then adds that chunk's conv2 contribution to the block's float32
//     output accumulators (registers);
//   - bf16: WMMA 16x16x16 fragments with float32 accumulators; a u row of
//     32 pixels is two fragments, an output row of 30 two (the last two
//     pixels are computed from zero u columns and dropped); Cout is padded
//     to 16 (not K3's 64). f32: FP32 FMA, no TF32.
// The recomputed ring costs 320/240 of conv1's work.
//
// Plain C interface for ctypes; the entry returns cudaGetLastError().

#include <mma.h>

#include "common.cuh"

using namespace irk;
using namespace nvcuda;

namespace {

constexpr int TH = 8;          // output rows per block
constexpr int TW = 30;         // output columns per block
constexpr int UH = TH + 2;     // u rows
constexpr int UW = TW + 2;     // u columns computed (two 16-pixel fragments)
constexpr int UWS = UW + 2;    // u columns stored: the last two stay zero
constexpr int IH = TH + 4;     // input rows
constexpr int IW = TW + 4;     // input columns
constexpr int NT = 256;
constexpr int MC = 32;         // bf16: Cmid channels per chunk
constexpr int MCF = 16;        // f32: Cmid channels per chunk

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

__host__ __device__ inline PairLayout bf16_layout(int cinp, int coutp) {
  PairLayout l;
  l.ldi = cinp + 16;
  l.ldw1 = MC + 8;
  l.ldu = MC + 16;
  l.ldw2 = coutp + 8;
  size_t o = 0;
  l.in = take(o, static_cast<size_t>(IH * IW) * l.ldi * 2);
  l.w1 = take(o, static_cast<size_t>(9 * cinp) * l.ldw1 * 2);
  l.u = take(o, static_cast<size_t>(UH * UWS) * l.ldu * 2);
  l.w2 = take(o, static_cast<size_t>(9 * MC) * l.ldw2 * 2);
  l.scr = take(o, static_cast<size_t>(NT / 32) * 256 * 4);
  l.total = o;
  return l;
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

__global__ void __launch_bounds__(NT) conv3x3_pair_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w1,
    const float* __restrict__ b1, const __nv_bfloat16* __restrict__ w2,
    const float* __restrict__ b2, __nv_bfloat16* __restrict__ out, int H,
    int W, int cin, int cinp, int cmidp, int cout, int coutp, int act) {
  extern __shared__ __align__(128) unsigned char smem[];
  const PairLayout L = bf16_layout(cinp, coutp);
  __nv_bfloat16* In = reinterpret_cast<__nv_bfloat16*>(smem + L.in);
  __nv_bfloat16* W1s = reinterpret_cast<__nv_bfloat16*>(smem + L.w1);
  __nv_bfloat16* U = reinterpret_cast<__nv_bfloat16*>(smem + L.u);
  __nv_bfloat16* W2s = reinterpret_cast<__nv_bfloat16*>(smem + L.w2);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float* scr = reinterpret_cast<float*>(smem + L.scr) + warp * 256;
  long long b;
  int y0, x0;
  tile_of(H, W, b, y0, x0);
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);

  // the input tile with its 2-pixel halo, zero outside the canvas and past
  // Cin; 16-byte copies where Cin allows
  const bool vec = cin % 8 == 0;
  const int per = vec ? cinp / 8 : cinp;
  for (int e = tid; e < IH * IW * per; e += NT) {
    const int p = e / per, c = e % per;
    const int y = y0 - 2 + p / IW, xx = x0 - 2 + p % IW;
    const bool in = y >= 0 && y < H && xx >= 0 && xx < W;
    const long long src = ((b * H + y) * W + xx) * cin;
    if (vec) {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (in && 8 * c < cin) v = *reinterpret_cast<const uint4*>(x + src + 8 * c);
      *reinterpret_cast<uint4*>(In + p * L.ldi + 8 * c) = v;
    } else {
      In[p * L.ldi + c] = in && c < cin ? x[src + c] : zero;
    }
  }
  // u's two stored columns past the computed ones stay zero
  for (int e = tid; e < UH * 2 * MC; e += NT) {
    const int r = e / (2 * MC), c = UW + (e / MC) % 2, k = e % MC;
    U[(r * UWS + c) * L.ldu + k] = zero;
  }

  const int nfo = coutp / 16;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc[2][2];
#pragma unroll
  for (int cf = 0; cf < 2; ++cf)
#pragma unroll
    for (int nf = 0; nf < 2; ++nf) wmma::fill_fragment(oacc[cf][nf], 0.f);

  for (int mc0 = 0; mc0 < cmidp; mc0 += MC) {
    __syncthreads();  // the previous chunk's u and weights are consumed
    for (int e = tid; e < 9 * cinp * (MC / 8); e += NT) {
      const int r = e / (MC / 8), ch = e % (MC / 8);
      cp_async16(W1s + r * L.ldw1 + ch * 8,
                 w1 + static_cast<long long>(r) * cmidp + mc0 + ch * 8);
    }
    const int c8 = coutp / 8;
    for (int e = tid; e < 9 * MC * c8; e += NT) {
      const int r = e / c8, ch = e % c8;
      const int tap = r / MC, k = r % MC;
      cp_async16(W2s + r * L.ldw2 + ch * 8,
                 w2 + (static_cast<long long>(tap) * cmidp + mc0 + k) * coutp +
                     ch * 8);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    // conv1: u on UH x UW pixels, M fragments of 16 pixels of one u row
    for (int mf = warp; mf < UH * 2; mf += NT / 32) {
      const int ur = mf / 2, uc0 = (mf % 2) * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
      wmma::fill_fragment(acc[0], 0.f);
      wmma::fill_fragment(acc[1], 0.f);
      for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3, dx = tap % 3;
        const __nv_bfloat16* ap = In + ((ur + dy) * IW + uc0 + dx) * L.ldi;
        const __nv_bfloat16* bp = W1s + tap * cinp * L.ldw1;
        for (int kk = 0; kk < cinp; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major>
              af;
          wmma::load_matrix_sync(af, ap + kk, L.ldi);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                           wmma::row_major>
                bf;
            wmma::load_matrix_sync(bf, bp + kk * L.ldw1 + j * 16, L.ldw1);
            wmma::mma_sync(acc[j], af, bf, acc[j]);
          }
        }
      }
      const int y = y0 - 1 + ur;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::store_matrix_sync(scr, acc[j], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int i = e / 16, n = e % 16;
          const int uc = uc0 + i, xx = x0 - 1 + uc;
          float v = act_fn(scr[e] + b1[mc0 + j * 16 + n], act);
          if (y < 0 || y >= H || xx < 0 || xx >= W) v = 0.f;
          U[(ur * UWS + uc) * L.ldu + j * 16 + n] = __float2bfloat16_rn(v);
        }
        __syncwarp();
      }
    }
    __syncthreads();

    // conv2: warp w owns output row w, two 16-pixel column fragments
    {
      const int r = warp;
      for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3, dx = tap % 3;
#pragma unroll
        for (int kk = 0; kk < MC; kk += 16) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major>
              bf[2];
#pragma unroll
          for (int nf = 0; nf < 2; ++nf)
            if (nf < nfo)
              wmma::load_matrix_sync(
                  bf[nf], W2s + (tap * MC + kk) * L.ldw2 + nf * 16, L.ldw2);
#pragma unroll
          for (int cf = 0; cf < 2; ++cf) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                           wmma::row_major>
                af;
            wmma::load_matrix_sync(
                af, U + ((r + dy) * UWS + cf * 16 + dx) * L.ldu + kk, L.ldu);
#pragma unroll
            for (int nf = 0; nf < 2; ++nf)
              if (nf < nfo) wmma::mma_sync(oacc[cf][nf], af, bf[nf],
                                           oacc[cf][nf]);
          }
        }
      }
    }
  }

  const int oy = y0 + warp;
#pragma unroll
  for (int cf = 0; cf < 2; ++cf)
#pragma unroll
    for (int nf = 0; nf < 2; ++nf) {
      if (nf >= nfo) continue;
      wmma::store_matrix_sync(scr, oacc[cf][nf], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int i = e / 16, co = nf * 16 + e % 16;
        const int oc = cf * 16 + i, ox = x0 + oc;
        if (oc < TW && ox < W && oy < H && co < cout)
          out[((b * H + oy) * W + ox) * cout + co] =
              __float2bfloat16_rn(scr[e] + b2[co]);
      }
      __syncwarp();
    }
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

}  // namespace

// bf16: cinp (a multiple of 16, <= 64), cmidp (of 32) and coutp (of 16,
// <= 32) are the padded widths of the kernel-form weights (3, 3, cinp,
// cmidp) and (3, 3, cmidp, coutp), the biases padded with zeros to them.
// f32: the weights are unpadded (cinp == cin, ...).
extern "C" int conv3x3_pair(const void* x, const void* w1, const void* b1,
                            const void* w2, const void* b2, void* out,
                            int bf16, int B, int H, int W, int cin, int cinp,
                            int cmid, int cmidp, int cout, int coutp,
                            int act, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long nblk = static_cast<long long>(B) * ((H + TH - 1) / TH) *
                         ((W + TW - 1) / TW);
  if (cinp > 64 || coutp > 32) return cudaErrorInvalidValue;
  if (bf16) {
    if (cinp % 16 || cmidp % MC || coutp % 16) return cudaErrorInvalidValue;
    const size_t smem = bf16_layout(cinp, coutp).total;
    const cudaError_t e = cudaFuncSetAttribute(
        conv3x3_pair_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    conv3x3_pair_mma_kernel<<<static_cast<unsigned>(nblk), NT, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w1), static_cast<const float*>(b1),
        static_cast<const __nv_bfloat16*>(w2), static_cast<const float*>(b2),
        static_cast<__nv_bfloat16*>(out), H, W, cin, cinp, cmidp, cout, coutp,
        act);
  } else {
    const size_t smem = f32_layout(cin, cout).total;
    const cudaError_t e = cudaFuncSetAttribute(
        conv3x3_pair_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    conv3x3_pair_kernel<<<static_cast<unsigned>(nblk), NT, smem, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w1),
        static_cast<const float*>(b1), static_cast<const float*>(w2),
        static_cast<const float*>(b2), static_cast<float*>(out), H, W, cin,
        cmid, cout, act);
  }
  return static_cast<int>(cudaGetLastError());
}
