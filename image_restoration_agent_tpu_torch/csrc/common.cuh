// Shared helpers of the port's CUDA kernels: float32 / bfloat16 loads and
// stores through one float interface, warp reductions, cp.async copies.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace irk {

// dtype codes passed from Python (ops/swin_block.py: _DT)
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// element `i` of a float32 or bfloat16 buffer, selected at run time
__device__ __forceinline__ float load_any(const void* p, long long i,
                                          int dt) {
  return dt == kBF16
             ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
             : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store_any(void* p, long long i, int dt,
                                          float v) {
  if (dt == kBF16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(p)[i] = v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// one 16-byte global -> shared copy that bypasses registers (both
// addresses 16-byte aligned); cp_async_commit closes the thread's group
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// 16 bytes global -> shared (both addresses 16-byte aligned), zero-filled
// when `bytes` is 0
__device__ __forceinline__ void cp_async16z(void* smem, const void* gmem,
                                            int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes));
}

// one 4-byte global -> shared copy (both addresses 4-byte aligned)
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

// 8 bytes global -> shared (both addresses 8-byte aligned), zero-filled
// when `bytes` is 0
__device__ __forceinline__ void cp_async8z(void* smem, const void* gmem,
                                           int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// the same with a run-time count n of 0-4
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  if (n <= 0)
    cp_async_wait<0>();
  else if (n == 1)
    cp_async_wait<1>();
  else if (n == 2)
    cp_async_wait<2>();
  else if (n == 3)
    cp_async_wait<3>();
  else
    cp_async_wait<4>();
}

// one global -> shared copy of `w` bytes (16, 8 or 4; both addresses
// w-byte aligned; w uniform across the warp)
__device__ __forceinline__ void cp_async_w(void* smem, const void* gmem,
                                           int w) {
  if (w == 16)
    cp_async16(smem, gmem);
  else if (w == 8)
    cp_async8z(smem, gmem, 8);
  else
    cp_async4(smem, gmem);
}

// ---------------------------------------------------------------------------
// mma.sync m16n8k16, bf16 x bf16 -> f32: d += a b for one warp. With g =
// lane / 4 and t = lane % 4, A (16 x 16, row-major) is a0 = (row g, k 2t
// and 2t+1), a1 = (g+8, 2t), a2 = (g, 2t+8), a3 = (g+8, 2t+8); B (16 x 8)
// is b0 = (k 2t and 2t+1, column g), b1 = (k 2t+8 and 2t+9, column g); D
// is d0, d1 = (row g, columns 2t, 2t+1), d2, d3 = (row g+8, the same). The
// lower k (or column) sits in the low 16 bits of each register.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16, `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// two bf16 values, `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// A pointer the compiler cannot see through (one register move it may not
// delete or hoist): loads of a kernel's weight vectors (biases, LayerNorm
// parameters) through it are the same values every iteration of a
// persistent loop, and the compiler would otherwise hoist them out of the
// loop into registers (hundreds a thread) and spill the accumulators around
// wgmma. The loads themselves stay ordinary, so they can be batched.
template <typename T>
__device__ __forceinline__ T* opaque(T* p) {
  T* q;
  asm volatile("mov.b64 %0, %1;\n" : "=l"(q) : "l"(p));
  return q;
}

// two floats (8-byte aligned) through the read-only cache
__device__ __forceinline__ float2 ldg2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

__device__ __forceinline__ int pmod(int a, int m) {
  int r = a % m;
  return r < 0 ? r + m : r;
}

// ---------------------------------------------------------------------------
// Split TF32 on mma.sync m16n8k8: the float32 products of K2
// (window_attention.cu), K4 and K5 (restormer_fused.cu)

// d += a b, TF32 in, float32 sum (mma.sync m16n8k8). With g = lane / 4 and
// t = lane % 4, A (16 x 8, row-major) is a0 = (row g, k t), a1 = (g+8, t),
// a2 = (g, t+4), a3 = (g+8, t+4); B (8 x 8) is b0 = (k t, column g), b1 =
// (k t+4, column g); D is as mma_bf16's (rows g, g+8; columns 2t, 2t+1).
// Not volatile: a pure function of its operands, which the compiler may
// interleave with other chains.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo in TF32 parts, with integer and float32 ops only: hi = x
// rounded to TF32 (nearest, ties away from zero, the low 13 bits clear),
// as cvt.rna.tf32.f32 rounds, and lo = x - hi (exact in float32), passed
// whole: the tensor cores read its top 19 bits. (cvt.rna.tf32.f32 runs on
// the conversion unit: four splits a product there set K2's pace.)
__device__ __forceinline__ void split1(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// an A fragment (a0 .. a3) split into TF32 parts
__device__ __forceinline__ void split_a(float a0, float a1, float a2,
                                        float a3, uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
  split1(a0, hi[0], lo[0]);
  split1(a1, hi[1], lo[1]);
  split1(a2, hi[2], lo[2]);
  split1(a3, hi[3], lo[3]);
}

// d += a b in split TF32, the three products in a fixed order: al bh, ah bl,
// ah bh (b = bh + bl split here)
__device__ __forceinline__ void mma_split(float (&d)[4],
                                          const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4], float b0,
                                          float b1) {
  uint32_t h0, h1, l0, l1;
  split1(b0, h0, l0);
  split1(b1, h1, l1);
  mma_tf32(d, al, h0, h1);
  mma_tf32(d, ah, l0, l1);
  mma_tf32(d, ah, h0, h1);
}

}  // namespace irk
