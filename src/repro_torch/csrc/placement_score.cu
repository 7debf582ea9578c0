// Replica-placement scorer, for Hopper (sm_90a).
//
// Replaces: repro/kernels/placement_score.py :: placement_score (the
// Pallas kernel over (block_r, G) demand slabs against the whole (K, G)
// candidate tables, writing (block_r, K) utility/feasibility tiles).
// Per cell (r, k) of the (R, K) grid, with G regions in a fixed order:
//
//   cost = store[k]; excess = 0
//   for g: cost = fma(reads[r,g],  rprice[k,g], cost)
//          cost = fma(writes[r,g], wprice[k,g], cost)
//          excess += 10 * ((reads + writes)[r,g] > 0 && rtt[k,g] > max_lat)
//   excess += 10 * !(valid[k] > 0)
//   feasible = excess == 0;  utility = -cost - 1e6 * excess
//
// The reference's jitted scorer contracts each cost update into one
// fused multiply-add, so the contract rounds once per update.  Every
// f32 operation here is an explicit intrinsic (__fmaf_rn for the two
// updates, __fadd_rn / __fmul_rn / __fsub_rn elsewhere): nvcc's
// -fmad=true cannot then change a rounding.  1e6 * excess is exact
// (excess <= 10 (G + 1)), so the last line rounds once either way.
//
// Bound on the H100: 8 bytes written per cell (utility + feasibility)
// against 8 G bytes read per row of K cells and ~5 G + 5 operations per
// cell: memory-bound on the (R, K) stores (5.08 GB at R = 5,000,000,
// K = 124, about 1.5 ms at 3.35 TB/s).  Design: each block stages the
// (K, G) price and latency tables and the (2, K) meta in shared memory
// once (~5 KB at K = 124), then walks the grid's cells with a grid-
// stride loop, k fastest, so consecutive threads store consecutive
// addresses of both outputs and a warp's demand loads hit one or two
// rows.  The grid is a fixed number of blocks per SM, so the tables are
// staged once per block, not once per tile; no padding of R is needed,
// the loop stops at the last cell.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 8;
constexpr float STRUCTURAL = 10.0f;
constexpr float PENALTY = 1.0e6f;

__global__ void placement_score_kernel(
    const float* __restrict__ reads, const float* __restrict__ writes,
    const float* __restrict__ rprice, const float* __restrict__ wprice,
    const float* __restrict__ rtt, const float* __restrict__ meta,
    long long r, int k, int g, float max_lat, float* __restrict__ util,
    int* __restrict__ feas) {
  extern __shared__ float s_tab[];
  float* s_rp = s_tab;              // (k, g)
  float* s_wp = s_rp + k * g;       // (k, g)
  float* s_rtt = s_wp + k * g;      // (k, g)
  float* s_meta = s_rtt + k * g;    // (2, k)
  for (int i = threadIdx.x; i < k * g; i += blockDim.x) {
    s_rp[i] = rprice[i];
    s_wp[i] = wprice[i];
    s_rtt[i] = rtt[i];
  }
  for (int i = threadIdx.x; i < 2 * k; i += blockDim.x) s_meta[i] = meta[i];
  __syncthreads();

  const long long cells = r * k;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  // (row, col) of the current cell, advanced by the stride without a
  // division per cell.
  long long row = first / k;
  int col = (int)(first - row * k);
  const long long row_step = stride / k;
  const int col_step = (int)(stride - row_step * k);
  for (long long cell = first; cell < cells; cell += stride) {
    const float* rd = reads + row * g;
    const float* wr = writes + row * g;
    float cost = s_meta[col];
    float excess = 0.0f;
    for (int gi = 0; gi < g; ++gi) {
      const float x = rd[gi];
      const float y = wr[gi];
      cost = __fmaf_rn(x, s_rp[col * g + gi], cost);
      cost = __fmaf_rn(y, s_wp[col * g + gi], cost);
      if (__fadd_rn(x, y) > 0.0f && s_rtt[col * g + gi] > max_lat)
        excess = __fadd_rn(excess, STRUCTURAL);
    }
    if (!(s_meta[k + col] > 0.0f)) excess = __fadd_rn(excess, STRUCTURAL);
    util[cell] = __fsub_rn(-cost, __fmul_rn(PENALTY, excess));
    feas[cell] = excess == 0.0f;
    row += row_step;
    col += col_step;
    if (col >= k) {
      col -= k;
      row += 1;
    }
  }
}

}  // namespace

// reads, writes: (r, g) f32; rprice, wprice, rtt: (k, g) f32; meta:
// (2, k) f32; outputs util (r, k) f32 and feas (r, k) int32.
extern "C" int placement_score_launch(const float* reads, const float* writes,
                                      const float* rprice, const float* wprice,
                                      const float* rtt, const float* meta,
                                      long long r, int k, int g, float max_lat,
                                      float* util, int* feas, void* stream) {
  if (r < 0 || k < 0 || g < 0) return (int)cudaErrorInvalidValue;
  if (r == 0 || k == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long cells = r * k;
  long long blocks = (cells + THREADS - 1) / THREADS;
  const long long cap = (long long)BLOCKS_PER_SM * (sms > 0 ? sms : 1);
  if (blocks > cap) blocks = cap;
  const size_t smem = (size_t)(3 * k * g + 2 * k) * sizeof(float);
  placement_score_kernel<<<(int)blocks, THREADS, smem, s>>>(
      reads, writes, rprice, wprice, rtt, meta, r, k, g, max_lat, util, feas);
  return (int)cudaGetLastError();
}
