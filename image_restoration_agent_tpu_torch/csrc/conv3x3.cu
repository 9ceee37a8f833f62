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
//   - float32 (conv3x3_tf32_kernel): the split-TF32 product on the Hopper
//     tensor cores (sm90_gemm.cuh: split_tf32, wgmma_split), float32
//     accuracy at three (two with bf16-rounded weights) TF32 passes; see
//     the note above the kernel.
//   - bfloat16 (conv3x3_mma_kernel): wgmma on the Hopper tensor cores, see
//     the note above the kernel.
//
// Plain C interface for ctypes; each entry returns cudaGetLastError().

#include "common.cuh"
#include "sm90_gemm.cuh"

using namespace irk;

namespace {

constexpr int TP = 64;  // output pixels per bf16 block row (one row segment)

// float32 on Hopper: the split-TF32 implicit GEMM, float32 accumulators in
// registers.
//   - Tile: a block owns 128 output pixels, TR rows x TC columns of one
//     image (TC 8, 16, 32 or 64 by the plan, TR = 128 / TC: a narrow
//     canvas's rows are flattened into the tile, so a 16 x 16 or 32 x 32
//     level fills whole tiles), and one slice of NS <= 128 output
//     channels; warpgroup g computes tile pixels 64 g .. 64 g + 63 (pixel m
//     at tile row m / TC, column m % TC) as one m64nNS accumulator.
//   - K: 8 input channels (32 bytes a pixel) a stage. Where the tiles and
//     slices cannot fill the card, the plan (conv3x3_plan) cuts the chunks
//     into nsplit contiguous ranges, one block each; the blocks write their
//     float32 sums to a workspace that conv3x3_tf32_reduce adds in a fixed
//     order, then applies the epilogue (no atomics: the same bits every
//     launch).
//   - Halo: (TR + 2) x (TC + 2) pixels x 8 channels a stage by 16-byte
//     cp.async, zero-filled past Cin and off the canvas (through registers
//     where Cin % 4 != 0 or the input is not 16-byte aligned); the folded
//     roll and the SAME padding are in the per-pixel source indices. A
//     pixel's two 16-byte halves are swapped where (p >> 2) & 1, so the
//     8 rows of an ldmatrix hit every bank once. With ln_pre each halo
//     pixel's float32 two-pass statistics are computed once per block (four
//     pixels a warp at a time, while the first stages land), and each
//     thread normalizes the pieces it copied once they land.
//   - Products: for tap (dy, dx) ldmatrix.x4 gathers each lane's pixel of
//     the tap (the lane gives its own row address: any pixel of the halo),
//     the fragment is split into TF32 hi and lo in registers, and 2 or 3
//     wgmma m64nNSk8 (xl wh, xh wl, xh wh) take B from the stage's weights
//     by descriptor: 18 or 27 a stage and warpgroup.
//   - Weights: conv3x3_weights packs wh (and wl, where the weights have
//     one) as [slice][Cin chunk][part][tap][k quad][NS/8][8][4] (the
//     no-swizzle K-major core matrices), so one 1-D bulk copy brings a
//     stage; its mbarrier counts the bytes.
//   - Pipeline: a ring of S stages (2-5, by shared memory). Stage j + S - 1
//     (weights by bulk copy from thread 0, halo by every thread) is issued
//     while stage j's wgmma run; one __syncthreads a stage frees the stage
//     the previous products read.
//   - Sums: each stage's products accumulate from zero in the wgmma
//     registers and are added into a second set of float32 registers once
//     the stage is done (the tensor cores' adds drift by about an ulp of
//     the partial sum each; a stage's partial keeps it to a few ulps).
//   - Epilogue from the sum registers: bias, LeakyReLU, residual in
//     float32, one float2 store per two columns (single stores where Cout
//     is odd); with split K the raw sums go to the workspace.
// What bounds it: the tensor cores at 2-3 TF32 passes (3 x FLOP / 495
// TFLOP/s) where the tiles fill the card; below that, the split's second
// pass and the ring's fill.
constexpr int F_CT = 256;                           // two warpgroups
constexpr int F_PIX = 128;                          // output pixels a block
constexpr int F_KC = 8;                             // input channels a stage
constexpr int F_MAXHALO = 4 * 66;                   // (TR + 2)(TC + 2), TC 64
constexpr int F_HALO_BYTES = F_MAXHALO * F_KC * 4;  // one halo stage
// barriers (128), src_s, mean_s, rstd_s; then S halo and S weight stages
constexpr int F_FIXED = 128 + F_MAXHALO * 8 + 2 * F_MAXHALO * 4;
static_assert(F_FIXED % 128 == 0 && F_HALO_BYTES % 128 == 0, "alignment");

constexpr size_t tf32_smem_bytes(int ns, int parts, int stages) {
  return F_FIXED + static_cast<size_t>(stages) *
                       (F_HALO_BYTES + 9 * F_KC * ns * 4 * parts);
}

// LayerNorm statistics of the block's npix halo pixels over Cin (float32,
// two passes, eps 1e-5; 0 and 0 off the canvas), four pixels a warp at once
__device__ __forceinline__ void halo_ln_stats_f32(
    const float* __restrict__ x, const long long* src_s, float* mean_s,
    float* rstd_s, int npix, int Cin) {
  constexpr int Q = 4;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int e0 = warp * Q; e0 < npix; e0 += Q * (F_CT / 32)) {
    long long s[Q];
    float mu[Q], rs[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      s[q] = e0 + q < npix ? src_s[e0 + q] : -1;
      mu[q] = 0.f;
      rs[q] = 0.f;
    }
    for (int c = lane; c < Cin; c += 32)
#pragma unroll
      for (int q = 0; q < Q; ++q)
        if (s[q] >= 0) mu[q] += x[s[q] * Cin + c];
#pragma unroll
    for (int q = 0; q < Q; ++q) mu[q] = warp_sum(mu[q]) / Cin;
    for (int c = lane; c < Cin; c += 32)
#pragma unroll
      for (int q = 0; q < Q; ++q)
        if (s[q] >= 0) {
          const float d = x[s[q] * Cin + c] - mu[q];
          rs[q] += d * d;
        }
#pragma unroll
    for (int q = 0; q < Q; ++q) rs[q] = warp_sum(rs[q]);
    if (lane < Q && e0 + lane < npix) {
      float m = mu[0], r = rs[0];
      bool on = s[0] >= 0;
#pragma unroll
      for (int q = 1; q < Q; ++q)
        if (lane == q) {
          m = mu[q];
          r = rs[q];
          on = s[q] >= 0;
        }
      mean_s[e0 + lane] = on ? m : 0.f;
      rstd_s[e0 + lane] = on ? rsqrtf(r / Cin + 1e-5f) : 0.f;
    }
  }
}

template <int NS>
__global__ void __launch_bounds__(F_CT, 1) conv3x3_tf32_kernel(
    const float* __restrict__ x, const float* __restrict__ wp,
    const float* __restrict__ bias, const float* __restrict__ res,
    const float* __restrict__ ln_g, const float* __restrict__ ln_b,
    float* __restrict__ out, float* __restrict__ ws, int B, int H, int W,
    int Cin, int Cout, int roll, int act, int tc, int nchunks, int nslices,
    int nsplit, int S, int parts, int vec) {
  constexpr int WTAP = F_KC * NS * 4;  // bytes of one tap's 8 x NS weights
  const int wstage = 9 * WTAP * parts;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  long long* src_s = reinterpret_cast<long long*>(smem + 128);
  float* mean_s = reinterpret_cast<float*>(smem + 128 + F_MAXHALO * 8);
  float* rstd_s = mean_s + F_MAXHALO;
  unsigned char* halo = smem + F_FIXED;
  unsigned char* wst = halo + S * F_HALO_BYTES;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wg = warp / 4, wq = warp % 4;
  const int tr = F_PIX / tc, hp = tc + 2, npix = (tr + 2) * hp;
  const int nxt = (W + tc - 1) / tc, nyt = (H + tr - 1) / tr;
  // block order: slice fastest, then the K part, the column tile, the row
  // tile, the image (ops/conv3x3.py:conv3x3_blocks walks the same order)
  long long bid = blockIdx.x;
  const int sl = static_cast<int>(bid % nslices);
  bid /= nslices;
  const int sp = static_cast<int>(bid % nsplit);
  bid /= nsplit;
  const int x0 = static_cast<int>(bid % nxt) * tc;
  bid /= nxt;
  const int y0 = static_cast<int>(bid % nyt) * tr;
  const long long b = bid / nyt;
  const int n0 = sl * NS;
  // this block's channel chunks: [c0, c0 + nc)
  const int c0 = static_cast<int>(static_cast<long long>(sp) * nchunks /
                                  nsplit);
  const int nc =
      static_cast<int>(static_cast<long long>(sp + 1) * nchunks / nsplit) -
      c0;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) mbar_init(&bars[s], 1);
    fence_barrier_init();
  }
  // halo pixel (r, p) sits at (y0 + r - 1, x0 + p - 1) of the rolled
  // canvas, whose pixel (i, j) is x[(i - roll) mod H, (j - roll) mod W]
  for (int e = tid; e < npix; e += F_CT) {
    const int r = e / hp, p = e - r * hp;
    const int ry = y0 + r - 1, rx = x0 + p - 1;
    long long s = -1;
    if (ry >= 0 && ry < H && rx >= 0 && rx < W)
      s = (b * H + pmod(ry - roll, H)) * W + pmod(rx - roll, W);
    src_s[e] = s;
  }
  __syncthreads();

  const bool ln = ln_g != nullptr;
  if (ln && !vec) {  // the register path normalizes while it stages
    halo_ln_stats_f32(x, src_s, mean_s, rstd_s, npix, Cin);
    __syncthreads();
  }
  const float* wsl =
      wp + (static_cast<long long>(sl) * nchunks + c0) * (wstage / 4);
  auto load_w = [&](int j) {  // thread 0: local stage j's weights
    const int st = j % S;
    mbar_arrive_expect_tx(&bars[st], wstage);
    bulk_g2s(wst + st * wstage, wsl + static_cast<long long>(j) * (wstage / 4),
             wstage, &bars[st]);
  };
  const int pre = S - 1 < nc ? S - 1 : nc;
  if (tid == 0)
    for (int j = 0; j < pre; ++j) load_w(j);

  // local stage j's halo: 16-byte halves (pixel e >> 1, channels 4 (e & 1)
  // .. of the chunk)
  auto stage_halo = [&](int j) {
    unsigned char* hs = halo + (j % S) * F_HALO_BYTES;
    const int cb = (c0 + j) * F_KC;
    for (int e = tid; e < 2 * npix; e += F_CT) {
      const int pe = e >> 1, h = e & 1;
      unsigned char* dst = hs + pe * 32 + ((h ^ ((pe >> 2) & 1)) << 4);
      const long long s = src_s[pe];
      const int ch = cb + 4 * h;
      if (vec) {
        const bool in = s >= 0 && ch < Cin;
        cp_async16z(dst, in ? x + s * Cin + ch : x, in ? 16 : 0);
        continue;
      }
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (s >= 0) {
        const float* px = x + s * Cin;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (ch + i < Cin) {
            v[i] = px[ch + i];
            if (ln)
              v[i] = (v[i] - mean_s[pe]) * rstd_s[pe] * ln_g[ch + i] +
                     ln_b[ch + i];
          }
      }
      *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    }
  };
  for (int j = 0; j < S - 1; ++j) {  // S - 1 groups, empty past the end
    if (j < nc) stage_halo(j);
    cp_async_commit();
  }
  // With ln_pre on the cp.async path the halo lands raw; each thread then
  // normalizes the 16-byte halves it copied itself, so its own
  // cp.async.wait_group is all the ordering it needs (the next
  // __syncthreads publishes them). Off the canvas and past Cin the zeros
  // stay zero.
  const bool ln_in_place = ln && vec;
  auto normalize_halo = [&](int j) {
    unsigned char* hs = halo + (j % S) * F_HALO_BYTES;
    const int cb = (c0 + j) * F_KC;
    for (int e = tid; e < 2 * npix; e += F_CT) {
      const int pe = e >> 1, h = e & 1;
      const int ch = cb + 4 * h;
      if (src_s[pe] < 0 || ch >= Cin) continue;
      float4* dst = reinterpret_cast<float4*>(hs + pe * 32 +
                                              ((h ^ ((pe >> 2) & 1)) << 4));
      float4 v = *dst;
      const float mu = mean_s[pe], rs = rstd_s[pe];
      v.x = (v.x - mu) * rs * ln_g[ch] + ln_b[ch];
      v.y = (v.y - mu) * rs * ln_g[ch + 1] + ln_b[ch + 1];
      v.z = (v.z - mu) * rs * ln_g[ch + 2] + ln_b[ch + 2];
      v.w = (v.w - mu) * rs * ln_g[ch + 3] + ln_b[ch + 3];
      *dst = v;
    }
  };
  if (ln_in_place) {
    halo_ln_stats_f32(x, src_s, mean_s, rstd_s, npix, Cin);
    __syncthreads();
    if (nc > 0) {
      cp_async_wait_upto(S - 2);  // stage 0 (the S - 2 after it may fly)
      normalize_halo(0);
    }
  }

  // this lane's ldmatrix row address of each tap: tile pixel m = 64 wg +
  // 16 wq + frag_row, at tile row m / tc, column m % tc
  uint32_t aoff[9];
  {
    const int m = 64 * wg + 16 * wq + frag_row(lane);
    const int r = m / tc, p = m - r * tc;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int pe = (r + tap / 3) * hp + p + tap % 3;
      aoff[tap] = pe * 32 + ((frag_khalf(lane) ^ ((pe >> 2) & 1)) << 4);
    }
  }
  // Two-level sums: a stage's 18 or 27 products accumulate in the wgmma
  // registers from zero, then add into tot with one float32 add (round to
  // nearest). The tensor cores' own adds drift by about an ulp of the
  // partial sum each (about 1e-4 of max|out| over UNet's 5760 k steps, the
  // f32 rule's limit); added a stage at a time the drift stays inside one
  // stage's partial, a few float32 ulps.
  float acc[NS / 2], tot[NS / 2];
#pragma unroll
  for (int i = 0; i < NS / 2; ++i) tot[i] = 0.f;
  uint32_t hi[9][4], lo[9][4];
  const bool wlo = parts == 2;
  for (int j = 0; j < nc; ++j) {
    const int st = j % S;
    // this thread's copies of stage j are done (S - 2 later ones may fly)
    cp_async_wait_upto(S - 2);
    __syncthreads();  // stage j's halo visible; stage j - 1 free
    mbar_wait(&bars[st], (j / S) & 1);
    const unsigned char* hs = halo + st * F_HALO_BYTES;
    const unsigned char* wsg = wst + st * wstage;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      uint32_t raw[4];
      ldmatrix_x4(raw, hs + aoff[tap]);
      split_tf32(raw, hi[tap], lo[tap]);
    }
    wgmma_fence();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap)
      wgmma_split<NS>(acc, hi[tap], lo[tap],
                      b_desc(wsg + tap * WTAP, NS * 16),
                      b_desc(wsg + (9 + tap) * WTAP, NS * 16), true, wlo,
                      tap > 0);
    wgmma_commit();
    const int jn = j + S - 1;  // refill the stage local chunk j - 1 used
    if (jn < nc) {
      if (tid == 0) load_w(jn);
      stage_halo(jn);
    }
    cp_async_commit();
    if (ln_in_place && j + 1 < nc) {  // stage j + 1, while j multiplies
      cp_async_wait_upto(S - 2);
      normalize_halo(j + 1);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(hi);
    fence_regs(lo);
#pragma unroll
    for (int i = 0; i < NS / 2; ++i) tot[i] += acc[i];
  }

  const int g = lane >> 2, t = lane & 3;
  const long long npx = static_cast<long long>(B) * H * W;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int m = 64 * wg + 16 * wq + g + 8 * half;
    const int r = m / tc, p = m - r * tc;
    const int y = y0 + r, xo = x0 + p;
    if (y >= H || xo >= W) continue;
    const long long pix = (b * H + y) * W + xo;
    if (ws != nullptr) {  // split K: this part's raw sums
      float* wrow = ws + (sp * npx + pix) * Cout;
#pragma unroll
      for (int j = 0; j < NS / 8; ++j) {
        const int col = n0 + 8 * j + 2 * t;
        if (col < Cout) wrow[col] = tot[4 * j + 2 * half];
        if (col + 1 < Cout) wrow[col + 1] = tot[4 * j + 2 * half + 1];
      }
      continue;
    }
    const long long o = pix * Cout;
#pragma unroll
    for (int j = 0; j < NS / 8; ++j) {
      const int col = n0 + 8 * j + 2 * t;
      if (col >= Cout) continue;
      float v[2] = {tot[4 * j + 2 * half], tot[4 * j + 2 * half + 1]};
      const int nv = col + 1 < Cout ? 2 : 1;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (i >= nv) continue;
        if (bias != nullptr) v[i] += bias[col + i];
        if (act == 1)
          v[i] = v[i] >= 0.f ? v[i] : 0.01f * v[i];
        else if (act == 2)
          v[i] = v[i] >= 0.f ? v[i] : 0.2f * v[i];
        if (res != nullptr) v[i] += res[o + col + i];
      }
      if (nv == 2 && (Cout & 1) == 0) {
        *reinterpret_cast<float2*>(out + o + col) = make_float2(v[0], v[1]);
      } else {
        out[o + col] = v[0];
        if (nv == 2) out[o + col + 1] = v[1];
      }
    }
  }
}

// split K's second pass: out = epilogue(sum of the nsplit parts, in order)
__global__ void __launch_bounds__(256) conv3x3_tf32_reduce(
    const float* __restrict__ ws, const float* __restrict__ bias,
    const float* __restrict__ res, float* __restrict__ out, long long total,
    int Cout, int nsplit, int act) {
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * 256) {
    float v = ws[i];
    for (int s = 1; s < nsplit; ++s) v += ws[s * total + i];
    if (bias != nullptr) v += bias[i % Cout];
    if (act == 1)
      v = v >= 0.f ? v : 0.01f * v;
    else if (act == 2)
      v = v >= 0.f ? v : 0.2f * v;
    if (res != nullptr) v += res[i];
    out[i] = v;
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
    cp_async_wait_upto(S - 2);  // stage 0 (the S - 2 after it may fly)
    normalize_halo(0);
  }

  float acc[NS / 2];
  uint32_t a[9][4];
  for (int c = 0; c < nchunks; ++c) {
    const int st = c % S;
    // this thread's copies of stage c are done (S - 2 later ones may fly)
    cp_async_wait_upto(S - 2);
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
      cp_async_wait_upto(S - 2);
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

// float32: `w` is the packed split-TF32 form of
// ops/conv3x3.py:conv3x3_weights (`parts` 1: wh alone, 2: wh and wl) for a
// slice width `ns` (an IRK_TF32_WIDTHS width); `tc` the tile's columns (8,
// 16, 32 or 64), `nsplit` the K parts, `stages` the ring depth and `smem`
// the shared-memory bytes of the wrapper's plan (conv3x3_plan), which must
// cover what the kernel lays out; `ws` the (nsplit, B*H*W, Cout) float32
// workspace where nsplit > 1 (else nullptr); `vec` 1 where the halo may be
// copied 16 bytes at a time (Cin % 4 == 0, x 16-byte aligned).
extern "C" int conv3x3_f32(const void* x, const void* w, const void* bias,
                           const void* res, const void* ln_g,
                           const void* ln_b, void* out, void* ws, int B,
                           int H, int W, int Cin, int Cout, int roll, int act,
                           int ns, int parts, int tc, int nsplit, int stages,
                           int smem, int vec, void* stream) {
  if ((tc != 8 && tc != 16 && tc != 32 && tc != 64) || stages < 2 ||
      stages > 5 || parts < 1 || parts > 2 || nsplit < 1 ||
      (nsplit > 1) != (ws != nullptr) ||
      static_cast<size_t>(smem) < tf32_smem_bytes(ns, parts, stages))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tr = F_PIX / tc;
  const int nchunks = (Cin + F_KC - 1) / F_KC;
  const int nslices = (Cout + ns - 1) / ns;
  const long long nblk = static_cast<long long>(B) * ((H + tr - 1) / tr) *
                         ((W + tc - 1) / tc) * nsplit * nslices;
  auto launch = [&](auto kernel) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<static_cast<unsigned>(nblk), F_CT, smem, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(bias), static_cast<const float*>(res),
        static_cast<const float*>(ln_g), static_cast<const float*>(ln_b),
        static_cast<float*>(out), static_cast<float*>(ws), B, H, W, Cin, Cout,
        roll, act, tc, nchunks, nslices, nsplit, stages, parts, vec);
    return static_cast<int>(cudaGetLastError());
  };
  int err = static_cast<int>(cudaErrorInvalidValue);
  switch (ns) {
#define IRK_CASE(n)                         \
  case n:                                   \
    err = launch(conv3x3_tf32_kernel<n>);   \
    break;
    IRK_TF32_WIDTHS(IRK_CASE)
#undef IRK_CASE
    default:
      break;
  }
  if (err != 0 || nsplit == 1) return err;
  const long long total = static_cast<long long>(B) * H * W * Cout;
  long long blocks = (total + 255) / 256;
  if (blocks > 132 * 16) blocks = 132 * 16;
  conv3x3_tf32_reduce<<<static_cast<unsigned>(blocks), 256, 0, s>>>(
      static_cast<const float*>(ws), static_cast<const float*>(bias),
      static_cast<const float*>(res), static_cast<float*>(out), total, Cout,
      nsplit, act);
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
