// Serial vector-clock chain of one op batch, for Hopper (sm_90a).
//
// Replaces: the lax.scan ``clock_step`` of
// repro/core/xstcc.py :: apply_op_batch (not a Pallas kernel: an XLA scan
// that is serial over the batch).  For op i of the batch, in order:
//
//   svc            = max(session_vc[c_i], replica_vc[p_i]);  svc[c_i] += 1
//   session_vc[c_i] = svc
//   if is_write[i]: replica_vc[p_i] = max(replica_vc[p_i], svc)
//   vcs[i]          = svc
//
// Why a kernel: as a loop of PyTorch ops on the card this chain costs
// about five launches per op.  Every step is component-wise, so component
// n of every clock depends only on component n of earlier ops: thread n
// walks the whole batch on its own column of session_vc / replica_vc,
// kept in shared memory, with no synchronisation inside the walk.  The
// batch's (client, replica, is_write) rows are staged through shared
// memory in chunks so the serial loop never waits on device memory.
//
// Bound on the H100: the work is 4 B C integer operations and
// (3 B + B C + 2 (C^2 + P C)) * 4 bytes; both bounds are microseconds or
// less.  The real limit is the serial dependence along the batch: B steps
// of a few shared-memory operations each, which one block of C threads
// runs at a few tens of nanoseconds per op.
//
// Wide clocks: when the C x C session clocks and P x C replica clocks do
// not fit one block's shared memory (C above ~230 at P = 3; the serving
// engine keeps one clock component per session, C = 16,384), the same
// walk runs on the outputs in device memory.  The launch copies the
// clocks into the outputs on the stream, and thread n of a grid of
// ceil(C / 256) blocks walks column n there; a warp's 32 columns are 32
// consecutive words, so each step is one coalesced load per table and
// one store.  Each step waits on its loads (device-memory latency, not
// bandwidth): B steps of ~1 us at worst.

#include <cuda_runtime.h>

namespace {

constexpr int CHUNK = 1024;
constexpr size_t SMEM_MAX = 232448;  // shared memory one H100 block can use

__global__ void chain_kernel(const int* __restrict__ client,
                             const int* __restrict__ replica,
                             const int* __restrict__ is_write, int b,
                             const int* __restrict__ session_vc,
                             const int* __restrict__ replica_vc, int c, int p,
                             int* __restrict__ vcs,
                             int* __restrict__ new_session_vc,
                             int* __restrict__ new_replica_vc) {
  extern __shared__ int smem[];
  int* s_svc = smem;                 // [c][c]
  int* s_rvc = s_svc + c * c;        // [p][c]
  int* s_cli = s_rvc + p * c;        // [CHUNK]
  int* s_rep = s_cli + CHUNK;        // [CHUNK]
  int* s_w = s_rep + CHUNK;          // [CHUNK]

  for (int k = threadIdx.x; k < c * c; k += blockDim.x) s_svc[k] = session_vc[k];
  for (int k = threadIdx.x; k < p * c; k += blockDim.x) s_rvc[k] = replica_vc[k];

  const int n = threadIdx.x;
  for (int base = 0; base < b; base += CHUNK) {
    const int len = min(CHUNK, b - base);
    __syncthreads();
    for (int k = threadIdx.x; k < len; k += blockDim.x) {
      s_cli[k] = client[base + k];
      s_rep[k] = replica[base + k];
      s_w[k] = is_write[base + k];
    }
    __syncthreads();
    if (n < c) {
      for (int k = 0; k < len; ++k) {
        const int ci = s_cli[k], pi = s_rep[k];
        const int v = max(s_svc[ci * c + n], s_rvc[pi * c + n]) + (n == ci);
        s_svc[ci * c + n] = v;
        if (s_w[k]) s_rvc[pi * c + n] = max(s_rvc[pi * c + n], v);
        vcs[(size_t)(base + k) * c + n] = v;
      }
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < c * c; k += blockDim.x) new_session_vc[k] = s_svc[k];
  for (int k = threadIdx.x; k < p * c; k += blockDim.x) new_replica_vc[k] = s_rvc[k];
}

// The same chain on clocks held in device memory: svc and rvc are the
// outputs, already holding the input clocks.
__global__ void chain_kernel_global(const int* __restrict__ client,
                                    const int* __restrict__ replica,
                                    const int* __restrict__ is_write, int b,
                                    int c, int* __restrict__ vcs,
                                    int* __restrict__ svc,
                                    int* __restrict__ rvc) {
  __shared__ int s_cli[CHUNK];
  __shared__ int s_rep[CHUNK];
  __shared__ int s_w[CHUNK];
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (int base = 0; base < b; base += CHUNK) {
    const int len = min(CHUNK, b - base);
    __syncthreads();
    for (int k = threadIdx.x; k < len; k += blockDim.x) {
      s_cli[k] = client[base + k];
      s_rep[k] = replica[base + k];
      s_w[k] = is_write[base + k];
    }
    __syncthreads();
    if (n < c) {
      for (int k = 0; k < len; ++k) {
        const long long ci = s_cli[k], pi = s_rep[k];
        int* sp = svc + ci * c + n;
        int* rp = rvc + pi * c + n;
        const int v = max(*sp, *rp) + (n == ci);
        *sp = v;
        if (s_w[k]) *rp = max(*rp, v);
        vcs[(long long)(base + k) * c + n] = v;
      }
    }
  }
}

}  // namespace

// client/replica/is_write: (b,) int32; session_vc: (c, c); replica_vc:
// (p, c); outputs vcs (b, c), new_session_vc (c, c), new_replica_vc (p, c).
extern "C" int vclock_chain_launch(const int* client, const int* replica,
                                   const int* is_write, int b,
                                   const int* session_vc,
                                   const int* replica_vc, int c, int p,
                                   int* vcs, int* new_session_vc,
                                   int* new_replica_vc, void* stream) {
  if (c <= 0 || p <= 0 || b < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = ((size_t)c * c + (size_t)p * c + 3 * CHUNK) * sizeof(int);
  if (c > 1024 || smem > SMEM_MAX) {
    cudaError_t e = cudaMemcpyAsync(new_session_vc, session_vc,
                                    (size_t)c * c * sizeof(int),
                                    cudaMemcpyDeviceToDevice, s);
    if (e == cudaSuccess)
      e = cudaMemcpyAsync(new_replica_vc, replica_vc,
                          (size_t)p * c * sizeof(int),
                          cudaMemcpyDeviceToDevice, s);
    if (e != cudaSuccess) return (int)e;
    if (b == 0) return (int)cudaGetLastError();
    const int threads = 256;
    chain_kernel_global<<<(c + threads - 1) / threads, threads, 0, s>>>(
        client, replica, is_write, b, c, vcs, new_session_vc, new_replica_vc);
    return (int)cudaGetLastError();
  }
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int threads = ((c + 31) / 32) * 32;
  chain_kernel<<<1, threads, smem, s>>>(client, replica, is_write, b,
                                        session_vc, replica_vc, c, p, vcs,
                                        new_session_vc, new_replica_vc);
  return (int)cudaGetLastError();
}
