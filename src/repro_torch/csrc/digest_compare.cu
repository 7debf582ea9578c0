// Gossip digest compare, for Hopper (sm_90a).
//
// Replaces: repro/kernels/digest_compare.py :: digest_compare_pallas
// (the Pallas kernel over (block, 16) tiles of packed digest pairs).
// Each row is one (pair, range): columns 0-3 side A's SUM, MAX, CHK,
// CNT, columns 4-7 side B's, column 8 VALID, the rest padding.  Per row:
//
//   d_*      = a_* - b_*                       (wrapping int32)
//   differ   = valid && any d_* != 0
//   tie      = d_max == 0 && d_sum == 0
//   a_behind = differ && (d_max < 0 || (d_max == 0 && d_sum < 0) || tie)
//   b_behind = differ && (d_max > 0 || (d_max == 0 && d_sum > 0) || tie)
//
// SUM and CHK wrap by design, so their differences overflow.  Signed
// overflow is undefined in C++, and a compiler may rewrite
// (a - b) < 0 as a < b, which gives another verdict; the differences
// are therefore taken in unsigned arithmetic and cast back to int.
//
// Bound on the H100: 64 bytes read and 16 written per row, a few dozen
// integer operations: memory-bound at any size, and at the engine's
// 3 pairs x 8 ranges = 24 rows the launch is all there is.  Design: one
// thread per row, the row loaded as 16-byte vectors (the padding
// quarter holds nothing the verdict reads and is skipped) and the
// verdict stored as one int4, so a warp reads and writes contiguous
// 16-byte lanes; the ragged last block is masked.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ int wrap_sub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

__global__ void digest_compare_kernel(const int4* __restrict__ packed, int m,
                                      int4* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const int4 a = packed[4 * (size_t)i + 0];   // A_SUM, A_MAX, A_CHK, A_CNT
  const int4 b = packed[4 * (size_t)i + 1];   // B_SUM, B_MAX, B_CHK, B_CNT
  const int4 c = packed[4 * (size_t)i + 2];   // VALID, padding
  const int d_sum = wrap_sub(a.x, b.x);
  const int d_max = wrap_sub(a.y, b.y);
  const int d_chk = wrap_sub(a.z, b.z);
  const int d_cnt = wrap_sub(a.w, b.w);
  const bool differ =
      c.x > 0 && (d_sum != 0 || d_max != 0 || d_chk != 0 || d_cnt != 0);
  const bool tie = d_max == 0 && d_sum == 0;
  const bool a_behind =
      differ && (d_max < 0 || (d_max == 0 && d_sum < 0) || tie);
  const bool b_behind =
      differ && (d_max > 0 || (d_max == 0 && d_sum > 0) || tie);
  out[i] = make_int4(differ, a_behind, b_behind, 0);
}

}  // namespace

// packed: (m, 16) int32, 16-byte aligned; out: (m, 4) int32.
extern "C" int digest_compare_launch(const int* packed, int m, int* out,
                                     void* stream) {
  if (m < 0) return (int)cudaErrorInvalidValue;
  if (m == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (m + THREADS - 1) / THREADS;
  digest_compare_kernel<<<blocks, THREADS, 0, s>>>(
      reinterpret_cast<const int4*>(packed), m, reinterpret_cast<int4*>(out));
  return (int)cudaGetLastError();
}
