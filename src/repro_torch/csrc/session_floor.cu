// Batched session-floor admission, for Hopper (sm_90a).
//
// Replaces: repro/kernels/session_floor.py :: session_floor (the Pallas
// kernel over (block, 8) tiles of ops against the whole (P, R) version
// table and (C, R) floor tables).  The contract is
// repro/kernels/ref.py :: session_admit_ref, exact int32.  Per op i with
// client c, replica p, resource r and ok = valid[i]:
//
//   raw      = replica_version[p, r]
//   floor    = max(read_floor[c, r], write_floor[c, r])
//   adm      = ok && raw >= floor
//   served   = ok ? (enforce ? max(raw, floor) : raw) : 0
//   floor_o  = ok ? floor : 0
//   new_read_floor = read_floor, then new_read_floor[c, r] max= served
//
// Two entries share the gathers:
//
//   session_floor_launch (admit_batch, the state kept): served, adm,
//     floor_o and new_read_floor.  The Pallas body gathers through f32
//     one-hot matmuls, exact only below 2^24, and accumulates the floor
//     update across sequential grid steps; neither is carried over.
//     Here the gathers are integer loads, the floor update an integer
//     atomicMax: max does not depend on the order of the updates, so the
//     result equals the plain version bit for bit, duplicate (c, r)
//     pairs included.  Every op reads the pre-batch floors (the
//     reference's concurrent admission), so new_read_floor is a separate
//     output: the launch first copies read_floor into it on the same
//     stream, then the kernel reads only read_floor and writes only
//     new_read_floor.  Like the reference, every op's served version
//     enters the max, an invalid op's as 0.
//   session_check_launch (the routers' admission, whose floor update the
//     routers discard: the observe read commits the floors later): adm
//     and floor_o only, as one (2, B) int32 [adm, floor_o].  The client
//     ids and the replicas come as one (2, B) int32 index, and the
//     resource is 0 unless given.  No served version, no (C, R) copy,
//     no atomics: with one host-to-device copy of the index and one copy
//     of the result back, a router's admission is three device
//     operations.
//
// Index arithmetic is 64-bit: c * R + r passes 2^31 at large tables (64
// clients x 5,000,000 rows is 3.2e8).  An op whose index lies outside
// the tables touches no memory and yields zeros.  Callers keep indices
// in range (the serving engine and the router refuse session ids outside
// it): the plain versions raise on an index past the end and wrap a
// negative one, as torch indexing does.
//
// Bound on the H100: per op 3 index loads, 3 gathered loads and 3
// output stores plus one atomic, ~10 integer operations: memory-bound.
// With new_read_floor a separate output the (C, R) copy dominates at
// large tables (2 C R 4 bytes: 2.56 GB at 64 x 5,000,000); without it
// the op traffic is ~40 B per op (the check's: 2 index loads, 3 gathered
// loads, 2 stores, ~28 B).  Design: one thread per op over a grid-stride
// loop of at most BLOCKS_PER_SM blocks per SM; the gathers are scattered
// by nature (one 4-byte word per cache line), so the op traffic is
// latency- rather than bandwidth-limited, and enough ops in flight hide
// it.  No matmul and no one-hot.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 8;

struct Tables {
  const int* rv;
  const int* rf;
  const int* wf;
  int n_replicas;
  long long n_clients;
  long long n_resources;
};

// The gathers of op (c, p, r): false when an index lies outside the
// tables, else raw and the pre-batch floor, and cr = c * R + r.
__device__ __forceinline__ bool gather(const Tables& t, long long c, long long p,
                                       long long r, int& raw, int& fl,
                                       long long& cr) {
  if (c < 0 || c >= t.n_clients || p < 0 || p >= t.n_replicas || r < 0 ||
      r >= t.n_resources)
    return false;
  cr = c * t.n_resources + r;
  raw = t.rv[p * t.n_resources + r];
  fl = max(t.rf[cr], t.wf[cr]);
  return true;
}

__global__ void session_admit_kernel(
    const Tables t, const int* __restrict__ client,
    const int* __restrict__ replica, const int* __restrict__ resource,
    const unsigned char* __restrict__ valid, long long b, int enforce,
    int* __restrict__ served, unsigned char* __restrict__ adm,
    int* __restrict__ floor_out, int* __restrict__ new_rf) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < b;
       i += stride) {
    int raw = 0, fl = 0;
    long long cr = 0;
    if (!gather(t, client[i], replica[i], resource[i], raw, fl, cr)) {
      served[i] = 0;
      adm[i] = 0;
      floor_out[i] = 0;
      continue;
    }
    const bool ok = valid == nullptr || valid[i] != 0;
    const int sv = ok ? (enforce ? max(raw, fl) : raw) : 0;
    served[i] = sv;
    adm[i] = (ok && raw >= fl) ? 1 : 0;
    floor_out[i] = ok ? fl : 0;
    atomicMax(new_rf + cr, sv);
  }
}

__global__ void session_check_kernel(
    const Tables t, const int* __restrict__ index,
    const int* __restrict__ resource, const unsigned char* __restrict__ valid,
    long long b, int* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < b;
       i += stride) {
    int raw = 0, fl = 0;
    long long cr = 0;
    const long long r = resource != nullptr ? resource[i] : 0;
    const bool ok = (valid == nullptr || valid[i] != 0) &&
                    gather(t, index[i], index[b + i], r, raw, fl, cr);
    out[i] = (ok && raw >= fl) ? 1 : 0;
    out[b + i] = ok ? fl : 0;
  }
}

int grid_for(long long b) {
  static int sms = 0;
  if (sms == 0) {
    int device = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (sms <= 0) sms = 1;
  }
  long long blocks = (b + THREADS - 1) / THREADS;
  const long long cap = (long long)BLOCKS_PER_SM * sms;
  return (int)(blocks > cap ? cap : blocks);
}

}  // namespace

// rv: (n_replicas, n_resources) int32; rf, wf: (n_clients, n_resources)
// int32; client, replica, resource: (b,) int32; valid: (b,) bool or
// null (every op valid).  Outputs: served (b,) int32, adm (b,) bool,
// floor_out (b,) int32, new_rf (n_clients, n_resources) int32.
extern "C" int session_floor_launch(
    const int* rv, const int* rf, const int* wf, int n_replicas,
    long long n_clients, long long n_resources, const int* client,
    const int* replica, const int* resource, const unsigned char* valid,
    long long b, int enforce, int* served, unsigned char* adm, int* floor_out,
    int* new_rf, void* stream) {
  if (b < 0 || n_replicas < 0 || n_clients < 0 || n_resources < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t table_bytes = (size_t)n_clients * (size_t)n_resources * sizeof(int);
  if (table_bytes > 0) {
    cudaError_t e = cudaMemcpyAsync(new_rf, rf, table_bytes,
                                    cudaMemcpyDeviceToDevice, st);
    if (e != cudaSuccess) return (int)e;
  }
  if (b == 0) return (int)cudaGetLastError();
  const Tables t = {rv, rf, wf, n_replicas, n_clients, n_resources};
  session_admit_kernel<<<grid_for(b), THREADS, 0, st>>>(
      t, client, replica, resource, valid, b, enforce, served, adm, floor_out,
      new_rf);
  return (int)cudaGetLastError();
}

// The tables as above; index: (2, b) int32, the client ids then the
// replicas; resource: (b,) int32 or null (every op at resource 0);
// valid: (b,) bool or null.  Output: out (2, b) int32, [adm, floor_out].
extern "C" int session_check_launch(
    const int* rv, const int* rf, const int* wf, int n_replicas,
    long long n_clients, long long n_resources, const int* index,
    const int* resource, const unsigned char* valid, long long b, int* out,
    void* stream) {
  if (b < 0 || n_replicas < 0 || n_clients < 0 || n_resources < 0)
    return (int)cudaErrorInvalidValue;
  if (b == 0) return (int)cudaSuccess;
  const Tables t = {rv, rf, wf, n_replicas, n_clients, n_resources};
  session_check_kernel<<<grid_for(b), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      t, index, resource, valid, b, out);
  return (int)cudaGetLastError();
}
