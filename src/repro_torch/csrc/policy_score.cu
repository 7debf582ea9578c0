// Adaptive-controller SLA scorer, for Hopper (sm_90a).
//
// Replaces: repro/kernels/policy_score.py :: policy_score (the Pallas
// kernel over (block_s, SP_COLS) session slabs against the whole
// (LVL_COLS, L) level table, writing (block_s, L) utility/feasibility
// tiles).  Per cell (s, l) of the (S, L) grid:
//
//   s_e, v_e = count > 0 ? (stale, viol) : (0, 0)
//   cost     = fma(rf, fma(s_e, repair, read_cost), (1 - rf) * write_cost)
//   excess   = max(s_e - max_stale, 0) / max(max_stale, 1e-6)
//            + max(v_e - max_viol, 0) / max(max_viol, 1e-6)
//            + 10 * (lat > max_lat) + 10 * (age > max_age)
//   feasible = excess == 0 && valid
//   utility  = valid ? fma(-1e6, excess, -cost) : 0
//
// The contract is the reference's scorer under jit: XLA contracts
// exactly the three multiply-adds written fma above into fused
// multiply-adds and rounds every other operation once.  So the three
// are __fmaf_rn and every other f32 operation is an explicit intrinsic
// (__fadd_rn, __fsub_rn, __fmul_rn, __fdiv_rn): neither -fmad nor
// -prec-div can change a rounding.  max is written by hand with
// jnp.maximum's semantics (NaN propagates; +0 wins a tie of zeros).
// The bounds max_lat and max_age may be inf, and a level's age is inf
// for untimed causal propagation; the comparisons take them as they are.
//
// Bound on the H100: per session 32 bytes of parameters, 12 L bytes of
// telemetry read and 8 L bytes of outputs written (152 bytes at L = 6),
// against ~20 operations per cell: memory-bound (0.0454 ms at S =
// 1,000,000, L = 6, 3.35 TB/s).  Design: one thread per (s, l) cell with
// a grid-stride loop over the row-major grid, so consecutive threads
// load and store consecutive addresses of the three inputs and both
// outputs; a row's 8 session parameters are read by its L neighbouring
// threads out of one cache line.  The 5 used rows of the level table
// (5 L floats) sit in shared memory, staged once per block; the grid is
// a fixed number of blocks per SM.  S is not padded: the loop stops at
// the last cell.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 8;
constexpr int MAX_LEVELS = 64;
constexpr int SP_COLS = 8;
constexpr int SP_READ_FRAC = 0, SP_MAX_STALE = 1, SP_MAX_VIOL = 2,
              SP_MAX_LAT = 3, SP_MAX_AGE = 4, SP_VALID = 5;
constexpr int LVL_READ_COST = 0, LVL_WRITE_COST = 1, LVL_REPAIR_COST = 2,
              LVL_READ_LAT = 3, LVL_STALE_AGE = 4, LVL_USED = 5;
constexpr float RATE_EPS = 1.0e-6f;
constexpr float STRUCTURAL = 10.0f;
constexpr float PENALTY = 1.0e6f;

// jnp.maximum: a NaN operand propagates; of two zeros, -0 only if both.
__device__ __forceinline__ float maxf(float a, float b) {
  const bool keep_a = (a != a) || (a > b) || (a == b && !signbit(a));
  return keep_a ? a : b;
}

__global__ void policy_score_kernel(
    const float* __restrict__ sess, const float* __restrict__ table,
    const float* __restrict__ stale, const float* __restrict__ viol,
    const float* __restrict__ count, long long s, int l,
    float* __restrict__ util, int* __restrict__ feas) {
  __shared__ float s_tab[LVL_USED * MAX_LEVELS];
  // The table is (LVL_COLS, l) row-major: its first LVL_USED rows are
  // its first LVL_USED * l floats.
  for (int i = threadIdx.x; i < LVL_USED * l; i += blockDim.x) s_tab[i] = table[i];
  __syncthreads();

  const long long cells = s * l;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long cell = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       cell < cells; cell += stride) {
    const long long row = cell / l;
    const int j = (int)(cell - row * l);
    const float* sp = sess + row * SP_COLS;
    const float rf = sp[SP_READ_FRAC];
    const float max_stale = sp[SP_MAX_STALE];
    const float max_viol = sp[SP_MAX_VIOL];
    const bool valid = sp[SP_VALID] > 0.0f;

    const bool has = count[cell] > 0.0f;
    const float s_e = has ? stale[cell] : 0.0f;
    const float v_e = has ? viol[cell] : 0.0f;

    const float cost = __fmaf_rn(
        rf, __fmaf_rn(s_e, s_tab[LVL_REPAIR_COST * l + j], s_tab[LVL_READ_COST * l + j]),
        __fmul_rn(__fsub_rn(1.0f, rf), s_tab[LVL_WRITE_COST * l + j]));
    float excess = __fadd_rn(
        __fdiv_rn(maxf(__fsub_rn(s_e, max_stale), 0.0f), maxf(max_stale, RATE_EPS)),
        __fdiv_rn(maxf(__fsub_rn(v_e, max_viol), 0.0f), maxf(max_viol, RATE_EPS)));
    excess = __fadd_rn(excess, __fmul_rn(
        STRUCTURAL, s_tab[LVL_READ_LAT * l + j] > sp[SP_MAX_LAT] ? 1.0f : 0.0f));
    excess = __fadd_rn(excess, __fmul_rn(
        STRUCTURAL, s_tab[LVL_STALE_AGE * l + j] > sp[SP_MAX_AGE] ? 1.0f : 0.0f));

    util[cell] = valid ? __fmaf_rn(-PENALTY, excess, -cost) : 0.0f;
    feas[cell] = (excess == 0.0f && valid) ? 1 : 0;
  }
}

}  // namespace

// sess: (s, 8) f32; table: (8, l) f32; stale, viol, count: (s, l) f32;
// outputs util (s, l) f32 and feas (s, l) int32.
extern "C" int policy_score_launch(const float* sess, const float* table,
                                   const float* stale, const float* viol,
                                   const float* count, long long s, int l,
                                   float* util, int* feas, void* stream) {
  if (s < 0 || l < 0 || l > MAX_LEVELS) return (int)cudaErrorInvalidValue;
  if (s == 0 || l == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long cells = s * l;
  long long blocks = (cells + THREADS - 1) / THREADS;
  const long long cap = (long long)BLOCKS_PER_SM * (sms > 0 ? sms : 1);
  if (blocks > cap) blocks = cap;
  policy_score_kernel<<<(int)blocks, THREADS, 0, st>>>(
      sess, table, stale, viol, count, s, l, util, feas);
  return (int)cudaGetLastError();
}
