// Batched op-ingestion prefixes (occ, raw, floor) for Hopper (sm_90a).
//
// Replaces: repro/kernels/op_ingest.py :: op_ingest_pallas (the Pallas TPU
// kernel, body _op_ingest_kernel).  Same contract as
// repro/kernels/ref.py :: op_ingest_ref, bit-exact in int32:
//
//   occ[i]   = #{ j < i : is_write[j] and resource[j] == resource[i] }
//   ver_w[i] = g0[i] + occ[i] + 1                          (write version)
//   raw[i]   = max(raw0[i],
//                  max{ ver_w[j] : j < i, is_write[j], same resource,
//                       replica[i] == replica[j] or op_index[i] >= apply[j] },
//                  max{ pend_version[q] : pend_live[q], same resource,
//                       op_index[i] >= pend_apply[q] })
//   contrib  = is_write ? ver_w : raw
//   floor[i] = max(floor0[i],
//                  max{ contrib[j] : j < i, same client and resource })
//
// The Pallas grid is sequential ("arbitrary"); its diagonal steps publish
// verw/contrib rows into a persistent buffer that later steps read.  CUDA
// blocks run in no order, so the chain occ -> verw -> raw/contrib -> floor
// needs a boundary visible to every row between passes.  Two designs, by
// padded batch Bp; the wrapper picks (kernels/op_ingest.py :: SMALL_MAX =
// 128: on the H100 the tile kernels already win at Bp = 256):
//
//   * small (Bp <= 128, the main path's B = 8..128; up to 1024 when the
//     caller forces it): ONE launch of one CTA, one thread per row.  The meta columns, verw and contrib
//     live in shared memory and __syncthreads() is the pass boundary; the
//     pending ring is read row by row with warp-uniform (broadcast) loads.
//     At these sizes the work is a few thousand pair tests: the cost is
//     the launch, so one launch replaces three.
//   * large: three launches (pass 1 with the pending sweep, pass 2, pass
//     3), each a grid of 32-row tiles with 16 warps per CTA.  Lane l of
//     every warp owns row 32 t + l; warp w sweeps its own slice of the
//     candidates, given by the plan (kernels/op_ingest.py :: ingest_plan,
//     a (Bp / 32, 16, 4) int32 array: batch slice [lo, hi) of [0, 32 t +
//     32) and pending slice [plo, phi) of [0, Qp)), reading each candidate
//     row with one warp-uniform 16-byte load.  The 16 partials of a row
//     (integer add for occ, max for the rest: both independent of order)
//     meet in shared memory, and warp 0 writes the row once: no atomics
//     and no initialisation pass.  At Bp = 4096 that is 128 CTAs of 512
//     threads, one per SM, against the former 32 CTAs of 128.  The
//     pending sweep does not depend on the batch and runs in pass 1,
//     which leaves raw = max(raw0, pending) for pass 2 to join.
//
// Bound on the H100: ~50 bytes per op, so operations bound it at large B:
// Bp (Bp - 1) / 2 pair tests in each of three passes plus Bp x Qp pending
// tests, a handful of integer operations each (the INT32 rate is 64 lanes
// per SM per clock, ~16.7 T op/s at 1.98 GHz).  At Bp = 4096, Qp = 8192:
// 8.4 M pairs x 3 + 33.5 M pending tests.  The design spreads them over
// every SM; candidate rows are read once per warp (a broadcast), not once
// per thread.
//
// Inert padding (pack_ops): rows beyond the true batch are reads on
// resource -1 with apply index NEVER = 2**30, pending slots beyond Q are
// dead with resource -1; they match no real op.

#include <cuda_runtime.h>

namespace {

constexpr int OP_COLS = 16;  // columns 0-3: client, replica, resource,
                             // is_write; then:
constexpr int GLOBAL0 = 4, RAW0 = 5, FLOOR0 = 6, OPIDX = 7, APPLYIDX = 8;
constexpr int PEND_COLS = 8; // columns 0-3: version, resource, live, apply
constexpr int ONE_CTA_MAX = 1024;  // most rows the one-CTA kernel takes
constexpr int ROWS = 32;     // rows per tile of the large path
constexpr int WARPS = 16;    // warps per tile (candidate slices)

__device__ __forceinline__ int4 meta_lo(const int* meta, int row) {
  return __ldg(reinterpret_cast<const int4*>(meta + row * OP_COLS));
}
__device__ __forceinline__ int4 meta_hi(const int* meta, int row) {
  return __ldg(reinterpret_cast<const int4*>(meta + row * OP_COLS + GLOBAL0));
}
__device__ __forceinline__ int4 pend_row(const int* pend, int q) {
  return __ldg(reinterpret_cast<const int4*>(pend + q * PEND_COLS));
}

// out rows: 0 occ, 1 raw, 2 floor, 3 verw, 4 contrib (each bp ints).

// Small batches: one CTA of bp threads, the three passes in one launch.
__global__ void __launch_bounds__(ONE_CTA_MAX)
    ingest_small_kernel(const int* __restrict__ meta, int bp,
                        const int* __restrict__ pend, int qp,
                        int* __restrict__ out) {
  __shared__ int s_cli[ONE_CTA_MAX], s_rep[ONE_CTA_MAX], s_res[ONE_CTA_MAX],
      s_w[ONE_CTA_MAX], s_app[ONE_CTA_MAX], s_ver[ONE_CTA_MAX],
      s_con[ONE_CTA_MAX];
  const int i = threadIdx.x;
  const int* row = meta + i * OP_COLS;
  const int4 lo = meta_lo(meta, i);  // client, replica, resource, is_write
  const int c_i = lo.x, p_i = lo.y, r_i = lo.z, w_i = lo.w > 0;
  const int g_i = __ldg(row + OPIDX);
  s_cli[i] = c_i;
  s_rep[i] = p_i;
  s_res[i] = r_i;
  s_w[i] = w_i;
  s_app[i] = __ldg(row + APPLYIDX);
  __syncthreads();

  int occ = 0;
  for (int j = 0; j < i; ++j) occ += s_w[j] & (s_res[j] == r_i);
  const int verw = w_i ? __ldg(row + GLOBAL0) + occ + 1 : 0;
  s_ver[i] = verw;
  __syncthreads();

  int vis = 0;
  for (int j = 0; j < i; ++j) {
    if (s_w[j] && s_res[j] == r_i && (s_rep[j] == p_i || g_i >= s_app[j]))
      vis = max(vis, s_ver[j]);
  }
  int pmax = 0;
  for (int q = 0; q < qp; ++q) {
    const int4 p = pend_row(pend, q);  // version, resource, live, apply
    if (p.z > 0 && p.y == r_i && g_i >= p.w) pmax = max(pmax, p.x);
  }
  const int raw = max(max(__ldg(row + RAW0), vis), pmax);
  const int con = w_i ? verw : raw;
  s_con[i] = con;
  __syncthreads();

  int fl = 0;
  for (int j = 0; j < i; ++j) {
    if (s_res[j] == r_i && s_cli[j] == c_i) fl = max(fl, s_con[j]);
  }
  out[i] = occ;
  out[bp + i] = raw;
  out[2 * bp + i] = max(__ldg(row + FLOOR0), fl);
  out[3 * bp + i] = verw;
  out[4 * bp + i] = con;
}

// Large batches.  Each kernel: CTA t = rows 32 t .. 32 t + 31, warp w =
// plan slice w, lane = row; partials meet in s_part[WARPS][ROWS].

// Max of the 16 partials of this lane's row; valid in warp 0.
__device__ __forceinline__ int row_max(int (*part)[ROWS], int warp, int lane,
                                       int x) {
  part[warp][lane] = x;
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int w = 1; w < WARPS; ++w) x = max(x, part[w][lane]);
  }
  return x;
}

// Pass 1: occ (batch slice) and the pending max (pending slice).
__global__ void __launch_bounds__(WARPS * 32)
    ingest_pass1(const int* __restrict__ meta, const int* __restrict__ pend,
                 const int4* __restrict__ plan, int bp,
                 int* __restrict__ out) {
  __shared__ int s_occ[WARPS][ROWS];
  __shared__ int s_pm[WARPS][ROWS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * ROWS + lane;
  const int4 sl = plan[blockIdx.x * WARPS + warp];  // lo, hi, plo, phi
  const int4 lo = meta_lo(meta, i);
  const int4 hi = meta_hi(meta, i);
  int occ = 0;
#pragma unroll 4
  for (int j = sl.x; j < sl.y; ++j) {
    const int4 c = meta_lo(meta, j);
    occ += (j < i) & (c.w > 0) & (c.z == lo.z);
  }
  int pmax = 0;
#pragma unroll 4
  for (int q = sl.z; q < sl.w; ++q) {
    const int4 p = pend_row(pend, q);
    if (p.z > 0 && p.y == lo.z && hi.w >= p.w) pmax = max(pmax, p.x);
  }
  s_occ[warp][lane] = occ;
  s_pm[warp][lane] = pmax;
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int w = 1; w < WARPS; ++w) {
      occ += s_occ[w][lane];
      pmax = max(pmax, s_pm[w][lane]);
    }
    out[i] = occ;
    out[bp + i] = max(hi.y, pmax);
    out[3 * bp + i] = lo.w > 0 ? hi.x + occ + 1 : 0;
  }
}

// Pass 2: the visible batch writes; raw and contrib final.
__global__ void __launch_bounds__(WARPS * 32)
    ingest_pass2(const int* __restrict__ meta, const int4* __restrict__ plan,
                 int bp, int* __restrict__ out) {
  __shared__ int s_part[WARPS][ROWS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * ROWS + lane;
  const int4 sl = plan[blockIdx.x * WARPS + warp];
  const int4 lo = meta_lo(meta, i);
  const int g_i = __ldg(meta + i * OP_COLS + OPIDX);
  const int* verw = out + 3 * bp;
  int vis = 0;
#pragma unroll 4
  for (int j = sl.x; j < sl.y; ++j) {
    const int4 c = meta_lo(meta, j);
    const int app = __ldg(meta + j * OP_COLS + APPLYIDX);
    if (j < i && c.w > 0 && c.z == lo.z && (c.y == lo.y || g_i >= app))
      vis = max(vis, verw[j]);
  }
  vis = row_max(s_part, warp, lane, vis);
  if (warp == 0) {
    const int raw = max(out[bp + i], vis);
    out[bp + i] = raw;
    out[4 * bp + i] = lo.w > 0 ? verw[i] : raw;
  }
}

// Pass 3: per-(client, resource) prefix max of contributions.
__global__ void __launch_bounds__(WARPS * 32)
    ingest_pass3(const int* __restrict__ meta, const int4* __restrict__ plan,
                 int bp, int* __restrict__ out) {
  __shared__ int s_part[WARPS][ROWS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * ROWS + lane;
  const int4 sl = plan[blockIdx.x * WARPS + warp];
  const int4 lo = meta_lo(meta, i);
  const int* contrib = out + 4 * bp;
  int m = 0;
#pragma unroll 4
  for (int j = sl.x; j < sl.y; ++j) {
    const int4 c = meta_lo(meta, j);
    if (j < i && c.z == lo.z && c.x == lo.x) m = max(m, contrib[j]);
  }
  m = row_max(s_part, warp, lane, m);
  if (warp == 0) out[2 * bp + i] = max(__ldg(meta + i * OP_COLS + FLOOR0), m);
}

}  // namespace

// meta: (bp, 16) int32 with bp a multiple of 128; pend: (qp, 8) int32;
// out: (5, bp) int32, rows occ, raw, floor, verw, contrib.  plan == NULL
// runs the one-CTA kernel (bp <= 1024); otherwise plan is the (bp / 32,
// 16, 4) int32 slice table and the three tile kernels run.
extern "C" int op_ingest_launch(const int* meta, int bp, const int* pend,
                                int qp, int* out, const int* plan,
                                void* stream) {
  if (bp <= 0 || bp % 128 != 0 || qp < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (plan == nullptr) {
    if (bp > ONE_CTA_MAX) return (int)cudaErrorInvalidValue;
    ingest_small_kernel<<<1, bp, 0, s>>>(meta, bp, pend, qp, out);
    return (int)cudaGetLastError();
  }
  const int4* pl = reinterpret_cast<const int4*>(plan);
  const int grid = bp / ROWS;
  ingest_pass1<<<grid, WARPS * 32, 0, s>>>(meta, pend, pl, bp, out);
  ingest_pass2<<<grid, WARPS * 32, 0, s>>>(meta, pl, bp, out);
  ingest_pass3<<<grid, WARPS * 32, 0, s>>>(meta, pl, bp, out);
  return (int)cudaGetLastError();
}
