// K6 roll2d: the cyclic roll of a (B, H, W, C) canvas by (shift, shift) on
// (H, W), replacing the TPU kernel
// image_restoration_agent_tpu/ops/pallas_attention.py:roll2d_pallas. See
// ops/roll2d.py for the contract and what bounds it.
//
// Each output row i of image b is input row (i - shift) mod H rotated by
// shift pixels. A pixel row of W*C elements is a run of U-sized units (the
// wrapper picks the widest of 16, 8, 4 or 2 bytes that divides the row, the
// rotation and the base addresses), so the rotation is a unit offset and
// every thread moves one unit: neighbouring threads read and write
// neighbouring units. Grid: x over a row's units, y over rows.
//
// Plain C interface for ctypes; the entry returns cudaGetLastError().

#include "common.cuh"

namespace {

constexpr int RT = 256;

template <typename U>
__global__ void __launch_bounds__(RT) roll2d_kernel(
    const U* __restrict__ x, U* __restrict__ out, long long rows, int H,
    int nu, int ru, int sh) {
  const int u = blockIdx.x * RT + threadIdx.x;
  if (u >= nu) return;
  int su = u - ru;
  if (su < 0) su += nu;
  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    const long long b = r / H;
    const int i = static_cast<int>(r - b * H);
    int si = i - sh;
    if (si < 0) si += H;
    out[r * nu + u] = x[(b * H + si) * nu + su];
  }
}

template <typename U>
void launch(const void* x, void* out, long long rows, int H, long long rb,
            long long shb, int sh, cudaStream_t s) {
  const int nu = static_cast<int>(rb / sizeof(U));
  const int ru = static_cast<int>(shb / sizeof(U));
  const dim3 grid((nu + RT - 1) / RT,
                  static_cast<unsigned>(rows < 65535 ? rows : 65535));
  roll2d_kernel<U><<<grid, RT, 0, s>>>(static_cast<const U*>(x),
                                       static_cast<U*>(out), rows, H, nu, ru,
                                       sh);
}

}  // namespace

// rows = B*H; row_bytes = W*C*element size; shift_bytes = (shift mod W) *
// C * element size; row_shift = shift mod H; unit = 16, 8, 4 or 2 bytes,
// dividing row_bytes, shift_bytes and both base addresses.
extern "C" int roll2d(const void* x, void* out, long long rows, int H,
                      long long row_bytes, long long shift_bytes,
                      int row_shift, int unit, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (row_bytes % unit || shift_bytes % unit ||
      row_bytes / unit > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  switch (unit) {
    case 16:
      launch<uint4>(x, out, rows, H, row_bytes, shift_bytes, row_shift, s);
      break;
    case 8:
      launch<uint2>(x, out, rows, H, row_bytes, shift_bytes, row_shift, s);
      break;
    case 4:
      launch<unsigned>(x, out, rows, H, row_bytes, shift_bytes, row_shift, s);
      break;
    case 2:
      launch<unsigned short>(x, out, rows, H, row_bytes, shift_bytes,
                             row_shift, s);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}
