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
//
// placement_select_kernel (one launch per plan): the same cells, reduced
// on the chip to each row's choice, as the planner's
// argmax(utility, axis=1) and the gathers of the chosen cell:
//
//   choice[r]   = the first k of maximal utility[r, k] (ties, -0.0
//                 against 0.0 included, go to the lowest k; a NaN
//                 utility is above every number and the first NaN wins,
//                 as np.argmax and torch.argmax rule)
//   utility[r], feasible[r] = that cell's values
//
// written as one (3, R) int32 result: [choice; utility's f32 bits;
// feasible].  Every cell's utility rounds as placement_score_kernel's:
// the same __fmaf_rn chain over the regions in order, then the same
// __fsub_rn.  The excess is a sum of n tens, exact, and 1e6 times it is
// 1e7 n, exact too, so the penalty is an exact FMA chain over the
// regions, d[r, g] * late[k, g] added to invalid[k], where d is 1.0 where
// (reads + writes)[r, g] > 0, late is 1e7 where rtt[k, g] > max_lat and
// invalid is 1e7 where the candidate is invalid (each 0.0 otherwise):
// full-rate FMAs, where a popcount of bit masks and its int-to-float
// conversion run at an eighth of their rate.
//
// Bound on the H100: what the function needs is 4 G + 5 operations per
// cell (the cost's 2 G FMAs at two operations each, the violation count,
// the penalty's product, the subtraction, the argmax's compare) against
// 8 G bytes read and 12 bytes written per row: operations bound (0.158
// ms at R = 5,000,000, K = 124, G = 3 at 67 T op/s; the bytes take 0.054
// ms).  The (R, K) grid, which set the first kernel's bound, is never
// written.  Design: one thread per row (SELECT_ROWS rows per thread, a
// block's width apart, which share each record load), so the argmax is a
// strict `>` scan in ascending k, np.argmax's own first-max rule, with no
// cross-lane reduction (tools/placement_select_designs.py times one warp
// per row, with a shuffle reduction, against it).  Each block stages one record per candidate in
// shared memory, once (see SelectRecord), so one candidate costs a thread
// ceil((3 G + 2) / 4) 16-byte loads for all its rows, and every lane of
// a warp reads the same record at once (a broadcast: no bank conflict).
// G is a template parameter (1 .. SELECT_MAX_G), so the rows' demand and
// the record sit in registers.  The scan carries only the best utility
// and its k; the chosen cell's penalty is recomputed once per row at the
// end.  One block per SELECT_ROWS * SELECT_THREADS rows, not a grid
// capped at the blocks resident at once, whose last wave ran part-full;
// each block stages its ~6 KB of records from L2.  The three outputs are
// written as three rows of consecutive words.

#include <climits>
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

constexpr int SELECT_THREADS = 256;
constexpr int SELECT_MAX_G = 8;
constexpr int SELECT_ROWS = 4;                      // rows per thread
// PENALTY * STRUCTURAL: the penalty of one violation.  1e6 * (10 n) ==
// 1e7 n exactly, and every partial sum of tens of millions up to
// (SELECT_MAX_G + 1) * 1e7 is exact in f32, so the FMA chain below gives
// the grid kernel's product bit for bit.
constexpr float VIOLATION = 1.0e7f;

// One candidate's record in shared memory: [read prices (G), write
// prices (G), storage $, late penalties (G), invalid penalty], padded to
// whole float4s.
template <int G>
struct SelectRecord {
  static constexpr int FLOATS = 3 * G + 2;
  static constexpr int VEC = (FLOATS + 3) / 4;
};

// Utility of one candidate's record (v) for one row: x, y its demand, d
// its demand flags (1.0 where (x + y)[g] > 0, else 0.0); *pen gets the
// penalty, 0.0 exactly where the cell is feasible.
template <int G>
__device__ __forceinline__ float select_cell(const float* v, const float (&x)[G],
                                             const float (&y)[G],
                                             const float (&d)[G], float* pen) {
  float cost = v[2 * G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    cost = __fmaf_rn(x[g], v[g], cost);
    cost = __fmaf_rn(y[g], v[G + g], cost);
  }
  float p = v[3 * G + 1];
#pragma unroll
  for (int g = 0; g < G; ++g) p = __fmaf_rn(d[g], v[2 * G + 1 + g], p);
  *pen = p;
  return __fsub_rn(-cost, p);
}

template <int G>
__device__ __forceinline__ void load_record(const float4* __restrict__ rec,
                                            float* v) {
#pragma unroll
  for (int i = 0; i < SelectRecord<G>::VEC; ++i) {
    const float4 q = rec[i];
    v[4 * i] = q.x;
    v[4 * i + 1] = q.y;
    v[4 * i + 2] = q.z;
    v[4 * i + 3] = q.w;
  }
}

template <int G>
__global__ void __launch_bounds__(SELECT_THREADS) placement_select_kernel(
    const float* __restrict__ reads, const float* __restrict__ writes,
    const float* __restrict__ rprice, const float* __restrict__ wprice,
    const float* __restrict__ rtt, const float* __restrict__ meta,
    long long r, int k, float max_lat, int* __restrict__ out) {
  using Rec = SelectRecord<G>;
  extern __shared__ float4 s_rec[];   // (k, VEC)
  for (int c = threadIdx.x; c < k; c += blockDim.x) {
    float v[4 * Rec::VEC];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      v[g] = rprice[c * G + g];
      v[G + g] = wprice[c * G + g];
      v[2 * G + 1 + g] = rtt[c * G + g] > max_lat ? VIOLATION : 0.0f;
    }
    v[2 * G] = meta[c];
    v[3 * G + 1] = meta[k + c] > 0.0f ? 0.0f : VIOLATION;
#pragma unroll
    for (int i = Rec::FLOATS; i < 4 * Rec::VEC; ++i) v[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < Rec::VEC; ++i)
      s_rec[c * Rec::VEC + i] =
          make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  }
  __syncthreads();

  // A block takes SELECT_ROWS * blockDim.x rows at a time, thread t rows
  // t, t + blockDim.x, ... (so a warp's loads and stores are consecutive
  // words), and one record load serves all of a thread's rows.  A ragged
  // tail row repeats the last row, unwritten.
  const long long stride = (long long)gridDim.x * blockDim.x * SELECT_ROWS;
  for (long long base = (long long)blockIdx.x * blockDim.x * SELECT_ROWS;
       base < r; base += stride) {
    float x[SELECT_ROWS][G], y[SELECT_ROWS][G], d[SELECT_ROWS][G];
    float best_u[SELECT_ROWS];
    int best_k[SELECT_ROWS];
#pragma unroll
    for (int j = 0; j < SELECT_ROWS; ++j) {
      long long row = base + (long long)j * blockDim.x + threadIdx.x;
      if (row >= r) row = r - 1;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        x[j][g] = reads[row * G + g];
        y[j][g] = writes[row * G + g];
        d[j][g] = __fadd_rn(x[j][g], y[j][g]) > 0.0f ? 1.0f : 0.0f;
      }
      best_u[j] = -__int_as_float(0x7f800000);   // -inf; k = 0 keeps it
      best_k[j] = 0;
    }
    for (int c = 0; c < k; ++c) {
      float v[4 * Rec::VEC];
      load_record<G>(s_rec + c * Rec::VEC, v);
#pragma unroll
      for (int j = 0; j < SELECT_ROWS; ++j) {
        float pen;
        const float u = select_cell<G>(v, x[j], y[j], d[j], &pen);
        // u > best, or u is NaN; never past a NaN already kept.
        if (best_u[j] == best_u[j] && !(u <= best_u[j])) {
          best_u[j] = u;
          best_k[j] = c;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < SELECT_ROWS; ++j) {
      const long long row = base + (long long)j * blockDim.x + threadIdx.x;
      if (row >= r) break;
      // The chosen cell's penalty, recomputed once instead of carried.
      float v[4 * Rec::VEC], pen;
      load_record<G>(s_rec + best_k[j] * Rec::VEC, v);
      select_cell<G>(v, x[j], y[j], d[j], &pen);
      out[row] = best_k[j];
      out[r + row] = __float_as_int(best_u[j]);
      out[2 * r + row] = pen == 0.0f;
    }
  }
}

template <int G>
int select_launch(const float* reads, const float* writes, const float* rprice,
                  const float* wprice, const float* rtt, const float* meta,
                  long long r, int k, float max_lat, int* out, cudaStream_t s) {
  const size_t smem = (size_t)k * SelectRecord<G>::VEC * sizeof(float4);
  const long long per_block = (long long)SELECT_THREADS * SELECT_ROWS;
  long long blocks = (r + per_block - 1) / per_block;
  if (blocks > INT_MAX) blocks = INT_MAX;   // the loop takes the rest
  placement_select_kernel<G><<<(int)blocks, SELECT_THREADS, smem, s>>>(
      reads, writes, rprice, wprice, rtt, meta, r, k, max_lat, out);
  return (int)cudaGetLastError();
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

// reads, writes: (r, g) f32; rprice, wprice, rtt: (k, g) f32; meta: (2, k)
// f32 (any of them views into one copy, or arrays of their own); out:
// (3, r) int32 [choice; utility bits; feasible].  1 <= g <= SELECT_MAX_G,
// k >= 1.
extern "C" int placement_select_launch(const float* reads, const float* writes,
                                       const float* rprice, const float* wprice,
                                       const float* rtt, const float* meta,
                                       long long r, int k, int g, float max_lat,
                                       int* out, void* stream) {
  if (r < 0 || k < 1 || g < 1 || g > SELECT_MAX_G)
    return (int)cudaErrorInvalidValue;
  if (r == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (g) {
#define PLACEMENT_SELECT_CASE(G)                                            \
  case G:                                                                   \
    return select_launch<G>(reads, writes, rprice, wprice, rtt, meta, r, k, \
                            max_lat, out, s);
    PLACEMENT_SELECT_CASE(1)
    PLACEMENT_SELECT_CASE(2)
    PLACEMENT_SELECT_CASE(3)
    PLACEMENT_SELECT_CASE(4)
    PLACEMENT_SELECT_CASE(5)
    PLACEMENT_SELECT_CASE(6)
    PLACEMENT_SELECT_CASE(7)
    PLACEMENT_SELECT_CASE(8)
#undef PLACEMENT_SELECT_CASE
  }
  return (int)cudaErrorInvalidValue;
}
