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
// Why three launches: the Pallas grid is sequential ("arbitrary"); its
// diagonal steps publish verw/contrib rows into a persistent buffer that
// later steps read.  CUDA blocks run in no order, so the dependency chain
// occ -> verw -> raw/contrib -> floor becomes three kernels, each a grid
// over 128-row tiles in which every block walks the column tiles u <= t
// through shared memory (one thread per row).  No (B, B) mask exists
// anywhere; scratch is O(B).
//
// Bound on the H100: at the main path's shapes (B = 8..128, one to a few
// tiles) the work is a few thousand pair tests and the kernels are bound
// by launch latency, not bytes (~50 B per op) or operations (~B^2/2 pair
// tests per pass).  At B = 4096 the pair sweep is ~8M tests per pass,
// served from shared memory; the design keeps every operand of the inner
// loop in shared memory and the meta rows are read once per tile.
//
// Inert padding (pack_ops): rows beyond the true batch are reads on
// resource -1 with apply index NEVER = 2**30, pending slots beyond Q are
// dead with resource -1; they match no real op.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 128;
constexpr int OP_COLS = 16;
constexpr int CLIENT = 0, REPLICA = 1, RESOURCE = 2, IS_WRITE = 3,
              GLOBAL0 = 4, RAW0 = 5, FLOOR0 = 6, OPIDX = 7, APPLYIDX = 8;
constexpr int PEND_COLS = 8;
constexpr int PVER = 0, PRES = 1, PLIVE = 2, PAPPLY = 3;

__device__ __forceinline__ int col(const int* meta, int row, int c) {
  return meta[row * OP_COLS + c];
}

// Pass 1: per-resource exclusive write count and the write versions.
__global__ void occ_kernel(const int* __restrict__ meta, int* __restrict__ occ,
                           int* __restrict__ verw) {
  __shared__ int s_res[TILE];
  __shared__ int s_w[TILE];
  const int t = blockIdx.x;
  const int i = t * TILE + threadIdx.x;
  const int r_i = col(meta, i, RESOURCE);
  int count = 0;
  for (int u = 0; u <= t; ++u) {
    const int j = u * TILE + threadIdx.x;
    s_res[threadIdx.x] = col(meta, j, RESOURCE);
    s_w[threadIdx.x] = col(meta, j, IS_WRITE);
    __syncthreads();
    const int jmax = (u == t) ? threadIdx.x : TILE;   // j < i
    for (int jj = 0; jj < jmax; ++jj) {
      count += (s_w[jj] > 0) & (s_res[jj] == r_i);
    }
    __syncthreads();
  }
  occ[i] = count;
  verw[i] = col(meta, i, IS_WRITE) > 0 ? col(meta, i, GLOBAL0) + count + 1 : 0;
}

// Pass 2: replica-visible version (batch writes + pending ring) and the
// session-floor contribution of each op.
__global__ void raw_kernel(const int* __restrict__ meta,
                           const int* __restrict__ verw,
                           const int* __restrict__ pend, int qp,
                           int* __restrict__ raw, int* __restrict__ contrib) {
  __shared__ int s_res[TILE];
  __shared__ int s_rep[TILE];
  __shared__ int s_app[TILE];
  __shared__ int s_ver[TILE];
  __shared__ int s_w[TILE];
  const int t = blockIdx.x;
  const int i = t * TILE + threadIdx.x;
  const int r_i = col(meta, i, RESOURCE);
  const int p_i = col(meta, i, REPLICA);
  const int g_i = col(meta, i, OPIDX);
  int vis = 0;
  for (int u = 0; u <= t; ++u) {
    const int j = u * TILE + threadIdx.x;
    s_res[threadIdx.x] = col(meta, j, RESOURCE);
    s_rep[threadIdx.x] = col(meta, j, REPLICA);
    s_app[threadIdx.x] = col(meta, j, APPLYIDX);
    s_w[threadIdx.x] = col(meta, j, IS_WRITE);
    s_ver[threadIdx.x] = verw[j];
    __syncthreads();
    const int jmax = (u == t) ? threadIdx.x : TILE;
    for (int jj = 0; jj < jmax; ++jj) {
      const bool v = (s_w[jj] > 0) && (s_res[jj] == r_i) &&
                     ((s_rep[jj] == p_i) || (g_i >= s_app[jj]));
      if (v) vis = max(vis, s_ver[jj]);
    }
    __syncthreads();
  }
  int pmax = 0;
  for (int q0 = 0; q0 < qp; q0 += TILE) {
    const int q = q0 + threadIdx.x;
    const bool in = q < qp;
    s_ver[threadIdx.x] = in ? pend[q * PEND_COLS + PVER] : 0;
    s_res[threadIdx.x] = in ? pend[q * PEND_COLS + PRES] : -1;
    s_w[threadIdx.x] = in ? pend[q * PEND_COLS + PLIVE] : 0;
    s_app[threadIdx.x] = in ? pend[q * PEND_COLS + PAPPLY] : 0;
    __syncthreads();
    const int qmax = min(TILE, qp - q0);
    for (int qq = 0; qq < qmax; ++qq) {
      const bool v = (s_w[qq] > 0) && (s_res[qq] == r_i) && (g_i >= s_app[qq]);
      if (v) pmax = max(pmax, s_ver[qq]);
    }
    __syncthreads();
  }
  const int r = max(max(col(meta, i, RAW0), vis), pmax);
  raw[i] = r;
  contrib[i] = col(meta, i, IS_WRITE) > 0 ? verw[i] : r;
}

// Pass 3: per-(client, resource) exclusive prefix max of contributions.
__global__ void floor_kernel(const int* __restrict__ meta,
                             const int* __restrict__ contrib,
                             int* __restrict__ floor_out) {
  __shared__ int s_res[TILE];
  __shared__ int s_cli[TILE];
  __shared__ int s_con[TILE];
  const int t = blockIdx.x;
  const int i = t * TILE + threadIdx.x;
  const int r_i = col(meta, i, RESOURCE);
  const int c_i = col(meta, i, CLIENT);
  int m = 0;
  for (int u = 0; u <= t; ++u) {
    const int j = u * TILE + threadIdx.x;
    s_res[threadIdx.x] = col(meta, j, RESOURCE);
    s_cli[threadIdx.x] = col(meta, j, CLIENT);
    s_con[threadIdx.x] = contrib[j];
    __syncthreads();
    const int jmax = (u == t) ? threadIdx.x : TILE;
    for (int jj = 0; jj < jmax; ++jj) {
      if ((s_res[jj] == r_i) && (s_cli[jj] == c_i)) m = max(m, s_con[jj]);
    }
    __syncthreads();
  }
  floor_out[i] = max(col(meta, i, FLOOR0), m);
}

}  // namespace

// meta: (bp, 16) int32 with bp a multiple of 128; pend: (qp, 8) int32.
// Outputs occ/raw/floor and scratch verw/contrib are (bp,) int32.
extern "C" int op_ingest_launch(const int* meta, int bp, const int* pend,
                                int qp, int* occ, int* raw, int* floor_out,
                                int* verw, int* contrib, void* stream) {
  if (bp <= 0 || bp % TILE != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = bp / TILE;
  occ_kernel<<<grid, TILE, 0, s>>>(meta, occ, verw);
  raw_kernel<<<grid, TILE, 0, s>>>(meta, verw, pend, qp, raw, contrib);
  floor_kernel<<<grid, TILE, 0, s>>>(meta, contrib, floor_out);
  return (int)cudaGetLastError();
}
