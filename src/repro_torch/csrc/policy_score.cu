// Adaptive-controller SLA scorer and level selection, for Hopper (sm_90a).
//
// Replaces: repro/kernels/policy_score.py :: policy_score (the Pallas
// kernel over (block_s, SP_COLS) session slabs against the whole
// (LVL_COLS, L) level table, writing (block_s, L) utility/feasibility
// tiles), and around it the reference controller's selection
// (repro/policy/controller.py :: AdaptiveController.aggregate, scores and
// select: the windowed sums, the rates, the session packing, the scorer,
// argmax and the exploration arm).  Per cell (s, l) of the (S, L) grid:
//
//   s_e, v_e = count > 0 ? (stale, viol) : (0, 0)
//   cost     = fma(rf, fma(s_e, repair, read_cost), (1 - rf) * write_cost)
//   excess   = max(s_e - max_stale, 0) / max(max_stale, 1e-6)
//            + max(v_e - max_viol, 0) / max(max_viol, 1e-6)
//            + 10 * (lat > max_lat) + 10 * (age > max_age)
//   feasible = excess == 0 && valid
//   utility  = valid ? fma(-1e6, excess, -cost) : 0
//
// and per session, in selection mode,
//
//   greedy = the first l of the largest utility (a NaN counts as the
//            largest, and the first NaN wins: torch.argmax, jnp.argmax)
//   choice = explore_u < epsilon ? arm : greedy
//
// Two sources of the per-cell telemetry and the per-session parameters:
//
//   rates (policy_score_launch, ops.policy_score): stale, viol, count
//     (S, L) and the packed (S, 8) session parameters, the reference
//     kernel's layout; writes utility and feasibility;
//   rings (policy_select_launch, the controller's selection): the three
//     (W, S, L) count rings of the controller's state, read in place.
//     Each cell's window sums are added slot by slot in index order
//     0 ... W-1 (obs.metrics.window_total's order, so they are exact
//     beyond integer counts too); count = the reads' sum, and
//     stale, viol = the sums over max(count, 1).  The SLA bounds, shared
//     by the fleet, come by value; the read fraction per session or by
//     value; valid per session or every row.  Writes the (S,) int32
//     choice, or utility and feasibility.
//
// The contract is the reference under jit: XLA contracts exactly the
// three multiply-adds written fma above into fused multiply-adds and
// rounds every other operation once.  So the three are __fmaf_rn and
// every other f32 operation is an explicit intrinsic (__fadd_rn,
// __fsub_rn, __fmul_rn, __fdiv_rn): neither -fmad nor -prec-div can
// change a rounding.  max is written by hand with jnp.maximum's
// semantics (NaN propagates; +0 wins a tie of zeros).  The bounds
// max_lat and max_age may be inf, and a level's age is inf for untimed
// causal propagation; the comparisons take them as they are.
//
// Bound on the H100: the rings are 3 W S L 4 bytes, read once (0.576 GB
// at S = 1,000,003, W = 8, L = 6), and a session's draws, read fraction
// and choice 16 bytes, against ~20 + 3 W operations per cell:
// memory-bound, 0.177 ms at 3.35 TB/s.  Design: one launch per selection
// (as PyTorch operations the selection is ~39 device operations: window
// sums, rates, packing, the scorer, argmax, the exploration select).  A
// block covers a whole number of sessions, one thread per cell along the
// contiguous (S, L) slot planes, so a warp's loads of one slot are 128
// consecutive bytes and each thread has its 3 W loads in flight; the 5 used
// rows of the level table sit in shared memory.  In selection mode the
// utilities are staged in shared memory and one thread per session scans
// its L values in order, so no utility reaches device memory.  Up to
// SMALL_CELLS cells one CTA covers the whole grid (S = 64, L = 6: one
// block of 384 threads); above, blocks of THREADS threads.  S is not
// padded: a block stops at the last session.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int SMALL_CELLS = 1024;
constexpr int MAX_LEVELS = 64;
constexpr int SP_COLS = 8;
constexpr int SP_READ_FRAC = 0, SP_MAX_STALE = 1, SP_MAX_VIOL = 2,
              SP_MAX_LAT = 3, SP_MAX_AGE = 4, SP_VALID = 5;
constexpr int LVL_READ_COST = 0, LVL_WRITE_COST = 1, LVL_REPAIR_COST = 2,
              LVL_READ_LAT = 3, LVL_STALE_AGE = 4, LVL_USED = 5;
constexpr float RATE_EPS = 1.0e-6f;
constexpr float STRUCTURAL = 10.0f;
constexpr float PENALTY = 1.0e6f;

struct Args {
  // Rings: the (w, s, l) stale, viol and reads counts.  Rates: stale,
  // viol and count (s, l), with w = 1.
  const float* stale;
  const float* viol;
  const float* count;
  int w;
  long long s;
  int l;
  const float* table;      // (8, l): rows LVL_*
  const float* sess;       // rates: (s, SP_COLS) session parameters
  const float* read_frac;  // rings: (s,), or null for rf_value
  const float* valid;      // rings: (s,) (> 0 is valid), or null for all
  float rf_value, max_stale, max_viol, max_lat, max_age;
  const float* explore_u;  // selection: (s,) uniforms
  const int* arm;          // selection: (s,) exploration arms
  float epsilon;
  int* choice;             // selection: (s,) int32
  float* util;             // scores: (s, l) f32
  int* feas;               // scores: (s, l) int32
  int sessions_per_block;
};

// jnp.maximum: a NaN operand propagates; of two zeros, -0 only if both.
__device__ __forceinline__ float maxf(float a, float b) {
  const bool keep_a = (a != a) || (a > b) || (a == b && !signbit(a));
  return keep_a ? a : b;
}

template <bool RINGS, bool SELECT>
__global__ void __launch_bounds__(SMALL_CELLS) policy_kernel(const Args a) {
  __shared__ float s_tab[LVL_USED * MAX_LEVELS];
  __shared__ float s_util[SELECT ? SMALL_CELLS : 1];
  const int l = a.l;
  // The table is (LVL_COLS, l) row-major: its first LVL_USED rows are
  // its first LVL_USED * l floats.
  for (int i = threadIdx.x; i < LVL_USED * l; i += blockDim.x) s_tab[i] = a.table[i];
  __syncthreads();

  const long long first = (long long)blockIdx.x * a.sessions_per_block;
  const long long left = a.s - first;
  const int n_sess = left < a.sessions_per_block ? (int)left : a.sessions_per_block;
  const int t = threadIdx.x;
  if (t < n_sess * l) {
    const int k = t / l;
    const int j = t - k * l;
    const long long row = first + k;
    const long long cell = first * l + t;

    float stale, viol, count, rf, max_stale, max_viol, max_lat, max_age;
    bool valid;
    if (RINGS) {
      const long long plane = a.s * l;
      float ss = a.stale[cell], sv = a.viol[cell], sr = a.count[cell];
#pragma unroll 8
      for (int w = 1; w < a.w; ++w) {
        const long long o = w * plane + cell;
        ss = __fadd_rn(ss, a.stale[o]);
        sv = __fadd_rn(sv, a.viol[o]);
        sr = __fadd_rn(sr, a.count[o]);
      }
      const float denom = maxf(sr, 1.0f);
      stale = __fdiv_rn(ss, denom);
      viol = __fdiv_rn(sv, denom);
      count = sr;
      rf = a.read_frac != nullptr ? a.read_frac[row] : a.rf_value;
      max_stale = a.max_stale;
      max_viol = a.max_viol;
      max_lat = a.max_lat;
      max_age = a.max_age;
      valid = a.valid == nullptr || a.valid[row] > 0.0f;
    } else {
      stale = a.stale[cell];
      viol = a.viol[cell];
      count = a.count[cell];
      const float* sp = a.sess + row * SP_COLS;
      rf = sp[SP_READ_FRAC];
      max_stale = sp[SP_MAX_STALE];
      max_viol = sp[SP_MAX_VIOL];
      max_lat = sp[SP_MAX_LAT];
      max_age = sp[SP_MAX_AGE];
      valid = sp[SP_VALID] > 0.0f;
    }

    const bool has = count > 0.0f;
    const float s_e = has ? stale : 0.0f;
    const float v_e = has ? viol : 0.0f;
    const float cost = __fmaf_rn(
        rf, __fmaf_rn(s_e, s_tab[LVL_REPAIR_COST * l + j], s_tab[LVL_READ_COST * l + j]),
        __fmul_rn(__fsub_rn(1.0f, rf), s_tab[LVL_WRITE_COST * l + j]));
    float excess = __fadd_rn(
        __fdiv_rn(maxf(__fsub_rn(s_e, max_stale), 0.0f), maxf(max_stale, RATE_EPS)),
        __fdiv_rn(maxf(__fsub_rn(v_e, max_viol), 0.0f), maxf(max_viol, RATE_EPS)));
    excess = __fadd_rn(excess, __fmul_rn(
        STRUCTURAL, s_tab[LVL_READ_LAT * l + j] > max_lat ? 1.0f : 0.0f));
    excess = __fadd_rn(excess, __fmul_rn(
        STRUCTURAL, s_tab[LVL_STALE_AGE * l + j] > max_age ? 1.0f : 0.0f));
    const float util = valid ? __fmaf_rn(-PENALTY, excess, -cost) : 0.0f;

    if (SELECT) {
      s_util[t] = util;
    } else {
      a.util[cell] = util;
      a.feas[cell] = (excess == 0.0f && valid) ? 1 : 0;
    }
  }
  if (SELECT) {
    __syncthreads();
    if (t < n_sess) {
      const float* u = s_util + t * l;
      float best = u[0];
      int arg = 0;
      for (int j = 1; j < l; ++j) {
        const float v = u[j];
        // Once a NaN leads it stays; else a NaN or a strictly larger
        // value takes the lead (ties keep the first level).
        if (best == best && (v != v || v > best)) {
          best = v;
          arg = j;
        }
      }
      const long long row = first + t;
      a.choice[row] = a.explore_u[row] < a.epsilon ? a.arm[row] : arg;
    }
  }
}

int launch(Args a, bool rings, cudaStream_t st) {
  if (a.s < 0 || a.l < 1 || a.l > MAX_LEVELS || a.w < 1) return (int)cudaErrorInvalidValue;
  if (a.s == 0) return (int)cudaSuccess;
  const long long cells = a.s * a.l;
  int threads;
  long long blocks;
  if (cells <= SMALL_CELLS) {
    a.sessions_per_block = (int)a.s;
    threads = (int)((cells + 31) / 32 * 32);
    blocks = 1;
  } else {
    a.sessions_per_block = THREADS / a.l;
    threads = THREADS;
    blocks = (a.s + a.sessions_per_block - 1) / a.sessions_per_block;
  }
  const bool select = a.choice != nullptr;
  if (rings && select) {
    policy_kernel<true, true><<<(unsigned)blocks, threads, 0, st>>>(a);
  } else if (rings) {
    policy_kernel<true, false><<<(unsigned)blocks, threads, 0, st>>>(a);
  } else {
    policy_kernel<false, false><<<(unsigned)blocks, threads, 0, st>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The reference kernel's layout: sess (s, 8), table (8, l), stale, viol,
// count (s, l), all f32; outputs util (s, l) f32 and feas (s, l) int32.
extern "C" int policy_score_launch(const float* sess, const float* table,
                                   const float* stale, const float* viol,
                                   const float* count, long long s, int l,
                                   float* util, int* feas, void* stream) {
  Args a = {};
  a.stale = stale;
  a.viol = viol;
  a.count = count;
  a.w = 1;
  a.s = s;
  a.l = l;
  a.table = table;
  a.sess = sess;
  a.util = util;
  a.feas = feas;
  return launch(a, false, static_cast<cudaStream_t>(stream));
}

// The controller's selection: the (w, s, l) f32 rings stale_win,
// viol_win, reads_win read in place; table (8, l) f32; read_frac (s,) f32
// or null (rf_value); valid (s,) f32 or null (every row valid); the SLA
// bounds by value.  With choice (s,) int32 non-null: explore_u (s,) f32,
// arm (s,) int32 and epsilon give the choice; otherwise util (s, l) f32
// and feas (s, l) int32 are written.
extern "C" int policy_select_launch(
    const float* stale_win, const float* viol_win, const float* reads_win,
    int w, long long s, int l, const float* table, const float* read_frac,
    float rf_value, const float* valid, float max_stale, float max_viol,
    float max_lat, float max_age, const float* explore_u, const int* arm,
    float epsilon, int* choice, float* util, int* feas, void* stream) {
  Args a = {};
  a.stale = stale_win;
  a.viol = viol_win;
  a.count = reads_win;
  a.w = w;
  a.s = s;
  a.l = l;
  a.table = table;
  a.read_frac = read_frac;
  a.rf_value = rf_value;
  a.valid = valid;
  a.max_stale = max_stale;
  a.max_viol = max_viol;
  a.max_lat = max_lat;
  a.max_age = max_age;
  a.explore_u = explore_u;
  a.arm = arm;
  a.epsilon = epsilon;
  a.choice = choice;
  a.util = util;
  a.feas = feas;
  if (choice != nullptr && (explore_u == nullptr || arm == nullptr))
    return (int)cudaErrorInvalidValue;
  return launch(a, true, static_cast<cudaStream_t>(stream));
}
