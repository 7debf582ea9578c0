// Fixed-bin metric histograms, for Hopper (sm_90a).
//
// Replaces: repro/kernels/histogram.py :: histogram_pallas (the Pallas
// kernel that walks the observation axis in column tiles and adds each
// tile's bin_tile counts into one persistent (M, n_bins) output block).
// Per observation v of row r with params (lo, inv_w) and mask bit k:
//
//   bin = clip(floor((v - lo) * inv_w), 0, n_bins - 1)
//   out[r][bin] += (k > 0)
//
// The bin index keeps the reference's two f32 roundings: __fsub_rn and
// __fmul_rn forbid a fused multiply-add, floorf is exact, and
// __float2int_rd converts with saturation (NaN -> 0) as XLA's convert
// does, before the clamp.  Values far beyond hi or below lo therefore
// land in the edge bins, never in an overflowed index.
//
// Bound on the H100: 8 bytes read per observation (value + mask) and a
// few operations: memory-bound, and at the engine's (2, B <= 4096) a
// single launch latency.  The TPU kernel's sequential grid carries the
// counts from tile to tile; CUDA blocks have no order, so each block
// (one row, one chunk of COLS_PER_BLOCK columns) counts into a
// shared-memory histogram with shared atomics, then adds its nonzero
// bins into the output, which the wrapper zeroes, with global atomics.
// Integer addition is order-free, so the counts are exact whatever
// order the atomics land in.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int COLS_PER_BLOCK = 1024;

__global__ void histogram_kernel(const float* __restrict__ vals,
                                 const int* __restrict__ mask,
                                 const float* __restrict__ params, int b,
                                 int n_bins, int* __restrict__ out) {
  extern __shared__ int s_hist[];
  const int row = blockIdx.y;
  for (int k = threadIdx.x; k < n_bins; k += blockDim.x) s_hist[k] = 0;
  __syncthreads();

  const float lo = params[2 * row];
  const float inv_w = params[2 * row + 1];
  const int c0 = blockIdx.x * COLS_PER_BLOCK;
  const int c1 = min(b, c0 + COLS_PER_BLOCK);
  const size_t base = (size_t)row * b;
  for (int c = c0 + threadIdx.x; c < c1; c += blockDim.x) {
    if (mask[base + c] > 0) {
      const float f = floorf(__fmul_rn(__fsub_rn(vals[base + c], lo), inv_w));
      const int idx = min(max(__float2int_rd(f), 0), n_bins - 1);
      atomicAdd(&s_hist[idx], 1);
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < n_bins; k += blockDim.x) {
    const int v = s_hist[k];
    if (v) atomicAdd(&out[(size_t)row * n_bins + k], v);
  }
}

}  // namespace

// vals: (m, b) f32; mask: (m, b) int32; params: (m, 2) f32 [lo, inv_w];
// out: (m, n_bins) int32, zeroed by the caller.
extern "C" int histogram_launch(const float* vals, const int* mask,
                                const float* params, int m, int b, int n_bins,
                                int* out, void* stream) {
  if (m < 0 || b < 0 || n_bins < 1 || m > 65535) return (int)cudaErrorInvalidValue;
  if (m == 0 || b == 0) return (int)cudaSuccess;
  const size_t smem = (size_t)n_bins * sizeof(int);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((b + COLS_PER_BLOCK - 1) / COLS_PER_BLOCK, m);
  histogram_kernel<<<grid, THREADS, smem, s>>>(vals, mask, params, b, n_bins,
                                               out);
  return (int)cudaGetLastError();
}
