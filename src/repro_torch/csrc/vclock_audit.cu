// Pairwise DUOT causality audit (paper eq. 1a-1d + timed bound) for Hopper.
//
// Replaces: repro/kernels/vclock_audit.py :: vclock_audit (the Pallas TPU
// kernel, body _audit_kernel).  Same contract as
// repro/kernels/ref.py :: vclock_audit_ref: an (M, M) int32 code matrix
//
//   code[i][j] = phase | viol << 8 | timed << 9
//
// with happens-before(a, b) <=> max_n(a_n - b_n) <= 0 and min_n(a_n - b_n) < 0
// over N-component vector clocks, and the phase / violation / timed rules
// of the reference (phase 1..4 same-client MR/MW/RYW/WFR, 5 cross-client
// TCC, 6 concurrent; delta <= 0 disables the timed flag).
//
// Design: a 2-D grid of 32 x 32 output tiles, one thread per (i, j) pair.
// Both tiles' clock rows are staged in shared memory with the row stride
// padded to N + 1 words, so the 32 threads of a warp (one i, 32 j's) read
// 32 distinct banks; the i-row is a broadcast.  Each thread reduces the N
// component differences to a max and a min in registers.
//
// Bound on the H100: the output is 4 M^2 bytes (16.8 MB at M = 2048, 1.07 GB
// at M = 16384), written once and coalesced along j; the clock compare is
// 3 N integer operations per pair.  At N = 16 the bytes bound it; at N = 64
// the integer operations come close.  The design writes each code once and
// never re-reads a clock row from device memory inside the reduction.

#include <cuda_runtime.h>

namespace {

constexpr int BT = 32;
constexpr int META_COLS = 8;
constexpr int CLIENT = 0, KIND = 1, RESOURCE = 2, VERSION = 3, SEQ = 4,
              VALID = 5;

__global__ void audit_kernel(const int* __restrict__ vc,
                             const int* __restrict__ meta, int m, int n,
                             int delta, int* __restrict__ out) {
  extern __shared__ int smem[];
  const int ns = n + 1;                 // padded row stride
  int* si = smem;                       // [BT][ns]
  int* sj = smem + BT * ns;             // [BT][ns]
  __shared__ int mi[BT][META_COLS];
  __shared__ int mj[BT][META_COLS];

  const int i0 = blockIdx.y * BT;
  const int j0 = blockIdx.x * BT;
  const int tid = threadIdx.y * BT + threadIdx.x;
  for (int k = tid; k < BT * n; k += BT * BT) {
    const int row = k / n, c = k % n;
    si[row * ns + c] = (i0 + row < m) ? vc[(size_t)(i0 + row) * n + c] : 0;
    sj[row * ns + c] = (j0 + row < m) ? vc[(size_t)(j0 + row) * n + c] : 0;
  }
  if (tid < BT * META_COLS) {
    const int row = tid / META_COLS, c = tid % META_COLS;
    mi[row][c] = (i0 + row < m) ? meta[(size_t)(i0 + row) * META_COLS + c] : 0;
    mj[row][c] = (j0 + row < m) ? meta[(size_t)(j0 + row) * META_COLS + c] : 0;
  }
  __syncthreads();

  const int ti = threadIdx.y, tj = threadIdx.x;
  const int i = i0 + ti, j = j0 + tj;
  if (i >= m || j >= m) return;

  const int* a = si + ti * ns;
  const int* b = sj + tj * ns;
  int maxd = -(1 << 30), mind = (1 << 30);
  for (int k = 0; k < n; ++k) {
    const int d = a[k] - b[k];
    maxd = max(maxd, d);
    mind = min(mind, d);
  }
  const bool hb = (maxd <= 0) && (mind < 0);

  const bool valid = (mi[ti][VALID] > 0) && (mj[tj][VALID] > 0);
  const bool same_res = mi[ti][RESOURCE] == mj[tj][RESOURCE];
  const bool ordered = mi[ti][SEQ] < mj[tj][SEQ];
  const bool same_client = mi[ti][CLIENT] == mj[tj][CLIENT];
  const int ki = mi[ti][KIND], kj = mj[tj][KIND];
  const int vi = mi[ti][VERSION], vj = mj[tj][VERSION];

  const bool base = valid && same_res && ordered;
  const bool sc = base && same_client && hb;
  int phase = 0;
  if (sc && ki == 0 && kj == 0) phase = 1;   // a1 MR
  if (sc && ki == 1 && kj == 1) phase = 2;   // a2 MW
  if (sc && ki == 1 && kj == 0) phase = 3;   // a3 RYW
  if (sc && ki == 0 && kj == 1) phase = 4;   // a4 WFR
  if (base && !same_client && hb) phase = 5; // b1 TCC
  if (base && !hb) phase = 6;                // b2 concurrent

  const bool viol = (phase == 1 && vj < vi) || (phase == 2 && vj <= vi) ||
                    (phase == 3 && vj < vi) || (phase == 4 && vj <= vi) ||
                    (phase == 5 && ki == 1 && kj == 0 && vj < vi);
  const int gap = mj[tj][SEQ] - mi[ti][SEQ];
  const bool timed = (delta > 0) && base && ki == 1 && kj == 0 &&
                     gap > delta && vj < vi;
  out[(size_t)i * m + j] = phase | ((int)viol << 8) | ((int)timed << 9);
}

}  // namespace

// vc: (m, n) int32; meta: (m, 8) int32 [client, kind, resource, version,
// seq, valid, 0, 0]; out: (m, m) int32.
extern "C" int vclock_audit_launch(const int* vc, const int* meta, int m,
                                   int n, int delta, int* out, void* stream) {
  if (m <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = 2 * BT * (size_t)(n + 1) * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        audit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int nb = (m + BT - 1) / BT;
  dim3 grid(nb, nb), block(BT, BT);
  audit_kernel<<<grid, block, smem, s>>>(vc, meta, m, n, delta, out);
  return (int)cudaGetLastError();
}
