// Fixed-bin metric histograms, for Hopper (sm_90a).
//
// Replaces: repro/kernels/histogram.py :: histogram_pallas,
// src/repro/kernels/histogram.py:114 (the Pallas kernel that walks the
// observation axis in column tiles and adds each tile's bin_tile counts
// into one persistent (M, n_bins) output block).  Per observation v of
// row r with params (lo, inv_w) and mask bit k:
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
// few operations: memory-bound, and at the engine's (2, B <= 4096) far
// below one launch (0.00002 ms).  So the design is about launches: ONE
// kernel per call, with no zero fill of the output and no global
// atomics.  Row r is counted by one CTA, whose threads stride over the
// row's columns (any B) and count into shared memory with shared
// atomics; after a barrier the CTA writes each bin of its row once, or
// adds it into the caller's running counts (``accumulate``).  Integer
// addition is order-free, so the counts are exact whatever order the
// atomics land in.  The params are an (M, 2) array; the mask is int32,
// bytes (bool) or absent (every observation counts).

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 512;
constexpr int UNROLL = 8;

template <typename MaskT>
__global__ void __launch_bounds__(THREADS)
histogram_kernel(const float* __restrict__ vals, const MaskT* __restrict__ mask,
                 const float* __restrict__ params, int b, int n_bins,
                 int* __restrict__ out, int accumulate) {
  extern __shared__ int s_hist[];
  const int row = blockIdx.x;
  for (int k = threadIdx.x; k < n_bins; k += blockDim.x) s_hist[k] = 0;
  __syncthreads();

  const float lo = params[2 * row];
  const float inv_w = params[2 * row + 1];
  const float* v_row = vals + (size_t)row * b;
  const MaskT* m_row = mask ? mask + (size_t)row * b : nullptr;
  const int stride = blockDim.x;
  const auto count = [&](float v, bool on) {
    if (on) {
      const float f = floorf(__fmul_rn(__fsub_rn(v, lo), inv_w));
      atomicAdd(&s_hist[min(max(__float2int_rd(f), 0), n_bins - 1)], 1);
    }
  };
  // UNROLL columns per thread in flight: their loads are issued before
  // the first count, so a thread waits on device memory once per group.
  int col = threadIdx.x;
  for (; col + (UNROLL - 1) * stride < b; col += UNROLL * stride) {
    float v[UNROLL];
    bool on[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      v[u] = v_row[col + u * stride];
      on[u] = !m_row || m_row[col + u * stride] > 0;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) count(v[u], on[u]);
  }
  for (; col < b; col += stride) count(v_row[col], !m_row || m_row[col] > 0);
  __syncthreads();
  int* o = out + (size_t)row * n_bins;
  for (int k = threadIdx.x; k < n_bins; k += blockDim.x)
    o[k] = accumulate ? o[k] + s_hist[k] : s_hist[k];
}

}  // namespace

// vals: (m, b) f32; mask: (m, b) int32, bytes (bool) or null; params:
// (m, 2) f32 [lo, inv_w]; out: (m, n_bins) int32, written or added to.
// cfg packs m (bits 0-31), n_bins (32-45), accumulate (46) and a byte
// mask (47): the fewer arguments, the cheaper the call from Python.
extern "C" int histogram_launch(const float* vals, const void* mask,
                                const float* params, int* out, void* stream,
                                long long cfg, int b) {
  const int m = (int)(cfg & 0x7FFFFFFF), n_bins = (int)((cfg >> 32) & 0x3FFF);
  const int accumulate = (int)((cfg >> 46) & 1);
  const bool mask_bytes = (cfg >> 47) & 1;
  const size_t smem = (size_t)n_bins * sizeof(int);
  if (m < 1 || b < 0 || n_bins < 1 || smem > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mask_bytes)
    histogram_kernel<unsigned char><<<m, THREADS, smem, s>>>(
        vals, static_cast<const unsigned char*>(mask), params, b, n_bins, out,
        accumulate);
  else
    histogram_kernel<int><<<m, THREADS, smem, s>>>(
        vals, static_cast<const int*>(mask), params, b, n_bins, out, accumulate);
  return (int)cudaGetLastError();
}
