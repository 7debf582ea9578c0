// Gossip digest compare, for Hopper (sm_90a).
//
// Replaces: repro/kernels/digest_compare.py :: digest_compare_pallas
// (the Pallas kernel over (block, 16) tiles of packed digest pairs).
// A verdict compares side A's and side B's (SUM, MAX, CHK, CNT) digest
// of one range:
//
//   d_*      = a_* - b_*                       (wrapping int32)
//   differ   = any d_* != 0
//   tie      = d_max == 0 && d_sum == 0
//   a_behind = differ && (d_max < 0 || (d_max == 0 && d_sum < 0) || tie)
//   b_behind = differ && (d_max > 0 || (d_max == 0 && d_sum > 0) || tie)
//
// SUM and CHK wrap by design, so their differences overflow.  Signed
// overflow is undefined in C++, and a compiler may rewrite
// (a - b) < 0 as a < b, which gives another verdict; the differences
// are therefore taken in unsigned arithmetic and cast back to int.
//
// The kernel reads the (P, K) table of int4 digests and the two (M,)
// int64 replica index vectors itself (one thread per (pair, range), each
// digest one 16-byte load) and writes the three (M, K) flags as bytes
// into one (3, M, K) bool output.  One launch per verdict set: no
// gathered copies, no packed rows, no flag casts.  An index outside
// [0, P) gives all-false flags and reads nothing (the wrapper refuses
// such pairs on the host first).
//
// Bound on the H100: 32 bytes read and 3 written per verdict and a few
// dozen integer operations, memory-bound at any size; at the fault
// path's 3 pairs x 8 ranges the launch is all there is, so the design
// is about launching once.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ int wrap_sub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

// (differ, a_behind, b_behind) of digests a and b.
__device__ __forceinline__ void verdict(int4 a, int4 b, bool& differ, bool& a_behind,
                                        bool& b_behind) {
  const int d_sum = wrap_sub(a.x, b.x);
  const int d_max = wrap_sub(a.y, b.y);
  const int d_chk = wrap_sub(a.z, b.z);
  const int d_cnt = wrap_sub(a.w, b.w);
  differ = d_sum != 0 || d_max != 0 || d_chk != 0 || d_cnt != 0;
  const bool tie = d_max == 0 && d_sum == 0;
  a_behind = differ && (d_max < 0 || (d_max == 0 && d_sum < 0) || tie);
  b_behind = differ && (d_max > 0 || (d_max == 0 && d_sum > 0) || tie);
}

__global__ void digest_pairs_kernel(const int4* __restrict__ dig, int p, int k,
                                    const long long* __restrict__ ia,
                                    const long long* __restrict__ ib,
                                    long long stride, long long mk,
                                    bool* __restrict__ out) {
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (t >= mk) return;
  const long long pair = t / k;
  const int r = (int)(t - pair * k);
  const long long a = ia[pair * stride], b = ib[pair * stride];
  bool differ = false, a_behind = false, b_behind = false;
  if (a >= 0 && a < p && b >= 0 && b < p)
    verdict(__ldg(dig + a * k + r), __ldg(dig + b * k + r), differ, a_behind,
            b_behind);
  out[t] = differ;
  out[mk + t] = a_behind;
  out[2 * mk + t] = b_behind;
}

}  // namespace

// dig: (p, k) int4 digests, 16-byte aligned; ia / ib: m int64 replica
// indices, element i at [i * stride]; out: (3, m, k) bool.  pk = p | k << 32,
// ms = m | stride << 32.
extern "C" int digest_pairs_launch(const int* dig, const long long* ia,
                                   const long long* ib, bool* out, void* stream,
                                   long long pk, long long ms) {
  const int p = (int)(pk & 0xffffffff), k = (int)(pk >> 32);
  const int m = (int)(ms & 0xffffffff);
  const long long stride = ms >> 32;
  if (m < 0 || k < 0 || p < 0) return (int)cudaErrorInvalidValue;
  const long long mk = (long long)m * k;
  if (mk == 0) return (int)cudaSuccess;
  const long long blocks = (mk + THREADS - 1) / THREADS;
  digest_pairs_kernel<<<(unsigned)blocks, THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const int4*>(dig), p, k, ia, ib, stride, mk, out);
  return (int)cudaGetLastError();
}
