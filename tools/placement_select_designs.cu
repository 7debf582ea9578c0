// Two designs of B.5's fused score-and-select beside the one shipped in
// src/repro_torch/csrc/placement_score.cu (placement_select_kernel), for
// tools/placement_select_designs.py, which builds this file, holds each
// design bit-equal to the shipped kernel and times all three on one card.
// Both compute the shipped kernel's function (the first k of maximal
// utility, that cell's utility bits and feasibility, as one (3, R) int32
// result) with the same rounding; only the layout of the work differs.
//
//   prev: the fused select's first design: one thread per two
//         consecutive rows, each candidate's record [read prices, write
//         prices, storage $, late bit mask] as float4s in shared memory,
//         the penalty as 1e7 * popc(late & demand).
//   warp: one warp per row (a grid-stride loop over rows), the tables
//         transposed to (fields, K) in shared memory so that a warp's
//         lanes read consecutive words, the row's 2G demand values loaded
//         by 2G lanes and broadcast with __shfl_sync; lane l scores k = l,
//         l + 32, ... with a strict `>`, then the warp reduces its 32
//         (utility, k) pairs with __shfl_xor_sync (the larger utility, a
//         NaN above every number, the lower k on equality); lane 0 writes.
//         The penalty is the shipped kernel's exact FMA chain.
//
// Entry points: select_prev_launch and select_warp_launch, with
// placement_select_launch's arguments; G = 3 only (the planner's three
// regions).

#include <climits>
#include <cuda_runtime.h>

namespace prev {

constexpr int SELECT_THREADS = 256;
constexpr int SELECT_MAX_G = 8;
constexpr int SELECT_ROWS = 2;                      // rows per thread
constexpr unsigned INVALID_BIT = 1u << 31;
// PENALTY * STRUCTURAL: 1e6 * (10 n) == 1e7 * n exactly for n < 2^24 /
// 78,125 (1e7 = 2^7 * 78,125), so one product gives the same bits.
constexpr float PENALTY_PER_VIOLATION = 1.0e7f;

template <int G>
struct SelectRecord {
  static constexpr int VEC = (2 * G + 2 + 3) / 4;   // float4s per candidate
};

// Utility of one candidate's record (v) for one row; *n its violations.
template <int G>
__device__ __forceinline__ float select_cell(const float* v, const float (&x)[G],
                                             const float (&y)[G],
                                             unsigned demand, int* n) {
  float cost = v[2 * G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    cost = __fmaf_rn(x[g], v[g], cost);
    cost = __fmaf_rn(y[g], v[G + g], cost);
  }
  *n = __popc(__float_as_uint(v[2 * G + 1]) & demand);
  return __fsub_rn(-cost, __fmul_rn(PENALTY_PER_VIOLATION, (float)*n));
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
__global__ void __launch_bounds__(SELECT_THREADS) prev_kernel(
    const float* __restrict__ reads, const float* __restrict__ writes,
    const float* __restrict__ rprice, const float* __restrict__ wprice,
    const float* __restrict__ rtt, const float* __restrict__ meta,
    long long r, int k, float max_lat, int* __restrict__ out) {
  constexpr int VEC = SelectRecord<G>::VEC;
  extern __shared__ float4 s_rec[];   // (k, VEC)
  for (int c = threadIdx.x; c < k; c += blockDim.x) {
    float v[4 * VEC];
    unsigned late = 0;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      v[g] = rprice[c * G + g];
      v[G + g] = wprice[c * G + g];
      if (rtt[c * G + g] > max_lat) late |= 1u << g;
    }
    if (!(meta[k + c] > 0.0f)) late |= INVALID_BIT;
    v[2 * G] = meta[c];
    v[2 * G + 1] = __uint_as_float(late);
#pragma unroll
    for (int i = 2 * G + 2; i < 4 * VEC; ++i) v[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      s_rec[c * VEC + i] =
          make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  }
  __syncthreads();

  // Each thread takes SELECT_ROWS consecutive rows, so one record load
  // serves them all; a ragged last row repeats its predecessor, unwritten.
  const long long stride = (long long)gridDim.x * blockDim.x * SELECT_ROWS;
  for (long long base =
           ((long long)blockIdx.x * blockDim.x + threadIdx.x) * SELECT_ROWS;
       base < r; base += stride) {
    float x[SELECT_ROWS][G], y[SELECT_ROWS][G];
    unsigned demand[SELECT_ROWS];
#pragma unroll
    for (int j = 0; j < SELECT_ROWS; ++j) {
      const long long row = base + j < r ? base + j : r - 1;
      demand[j] = INVALID_BIT;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        x[j][g] = reads[row * G + g];
        y[j][g] = writes[row * G + g];
        if (__fadd_rn(x[j][g], y[j][g]) > 0.0f) demand[j] |= 1u << g;
      }
    }
    float v[4 * VEC];
    load_record<G>(s_rec, v);
    float best_u[SELECT_ROWS];
    int best_k[SELECT_ROWS];
#pragma unroll
    for (int j = 0; j < SELECT_ROWS; ++j) {
      int n;
      best_u[j] = select_cell<G>(v, x[j], y[j], demand[j], &n);
      best_k[j] = 0;
    }
    for (int c = 1; c < k; ++c) {
      load_record<G>(s_rec + c * VEC, v);
#pragma unroll
      for (int j = 0; j < SELECT_ROWS; ++j) {
        int n;
        const float u = select_cell<G>(v, x[j], y[j], demand[j], &n);
        // u > best, or u is NaN; never past a NaN already kept.
        if (best_u[j] == best_u[j] && !(u <= best_u[j])) {
          best_u[j] = u;
          best_k[j] = c;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < SELECT_ROWS; ++j) {
      if (base + j >= r) break;
      // The chosen cell's violations, recounted once instead of carried.
      load_record<G>(s_rec + best_k[j] * VEC, v);
      int n;
      select_cell<G>(v, x[j], y[j], demand[j], &n);
      out[base + j] = best_k[j];
      out[r + base + j] = __float_as_int(best_u[j]);
      out[2 * r + base + j] = n == 0;
    }
  }
}

template <int G>
int prev_launch(const float* reads, const float* writes, const float* rprice,
                  const float* wprice, const float* rtt, const float* meta,
                  long long r, int k, float max_lat, int* out, cudaStream_t s) {
  const size_t smem = (size_t)k * SelectRecord<G>::VEC * sizeof(float4);
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, prev_kernel<G>, SELECT_THREADS, smem);
  const long long per_block = (long long)SELECT_THREADS * SELECT_ROWS;
  long long blocks = (r + per_block - 1) / per_block;
  const long long cap =
      (long long)(per_sm > 0 ? per_sm : 1) * (sms > 0 ? sms : 1);
  if (blocks > cap) blocks = cap;
  prev_kernel<G><<<(int)blocks, SELECT_THREADS, smem, s>>>(
      reads, writes, rprice, wprice, rtt, meta, r, k, max_lat, out);
  return (int)cudaGetLastError();
}

}  // namespace prev

namespace warp {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr float VIOLATION = 1.0e7f;

// Field f of candidate c sits at s[f * k + c]; fields: read prices (G),
// write prices (G), storage $, late penalties (G), invalid penalty.
template <int G>
__device__ __forceinline__ float cell(const float* s, int k, int c,
                                      const float (&x)[G], const float (&y)[G],
                                      const float (&d)[G], float* pen) {
  float cost = s[2 * G * k + c];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    cost = __fmaf_rn(x[g], s[g * k + c], cost);
    cost = __fmaf_rn(y[g], s[(G + g) * k + c], cost);
  }
  float p = s[(3 * G + 1) * k + c];
#pragma unroll
  for (int g = 0; g < G; ++g) p = __fmaf_rn(d[g], s[(2 * G + 1 + g) * k + c], p);
  *pen = p;
  return __fsub_rn(-cost, p);
}

// Whether (uo, ko) comes before (um, km) in argmax's order.
__device__ __forceinline__ bool beats(float uo, int ko, float um, int km) {
  if (uo != uo) return um == um || ko < km;
  if (um != um) return false;
  return uo > um || (uo == um && ko < km);
}

template <int G>
__global__ void __launch_bounds__(THREADS) warp_kernel(
    const float* __restrict__ reads, const float* __restrict__ writes,
    const float* __restrict__ rprice, const float* __restrict__ wprice,
    const float* __restrict__ rtt, const float* __restrict__ meta,
    long long r, int k, float max_lat, int* __restrict__ out) {
  extern __shared__ float s[];   // (3 G + 2, k)
  for (int c = threadIdx.x; c < k; c += blockDim.x) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      s[g * k + c] = rprice[c * G + g];
      s[(G + g) * k + c] = wprice[c * G + g];
      s[(2 * G + 1 + g) * k + c] = rtt[c * G + g] > max_lat ? VIOLATION : 0.0f;
    }
    s[2 * G * k + c] = meta[c];
    s[(3 * G + 1) * k + c] = meta[k + c] > 0.0f ? 0.0f : VIOLATION;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * WARPS;
  for (long long row = (long long)blockIdx.x * WARPS + threadIdx.x / 32; row < r;
       row += warps) {
    float mine = 0.0f;
    if (lane < G) mine = reads[row * G + lane];
    else if (lane < 2 * G) mine = writes[row * G + lane - G];
    float x[G], y[G], d[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      x[g] = __shfl_sync(FULL, mine, g);
      y[g] = __shfl_sync(FULL, mine, G + g);
      d[g] = __fadd_rn(x[g], y[g]) > 0.0f ? 1.0f : 0.0f;
    }
    // -inf at the lane's first k (or no k at all: INT_MAX) until beaten.
    float best_u = -__int_as_float(0x7f800000);
    int best_k = lane < k ? lane : INT_MAX;
    for (int c = lane; c < k; c += 32) {
      float pen;
      const float u = cell<G>(s, k, c, x, y, d, &pen);
      if (best_u == best_u && !(u <= best_u)) {
        best_u = u;
        best_k = c;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float uo = __shfl_xor_sync(FULL, best_u, off);
      const int ko = __shfl_xor_sync(FULL, best_k, off);
      if (beats(uo, ko, best_u, best_k)) {
        best_u = uo;
        best_k = ko;
      }
    }
    if (lane == 0) {
      float pen;
      cell<G>(s, k, best_k, x, y, d, &pen);
      out[row] = best_k;
      out[r + row] = __float_as_int(best_u);
      out[2 * r + row] = pen == 0.0f;
    }
  }
}

template <int G>
int warp_launch(const float* reads, const float* writes, const float* rprice,
                const float* wprice, const float* rtt, const float* meta,
                long long r, int k, float max_lat, int* out, cudaStream_t st) {
  const size_t smem = (size_t)(3 * G + 2) * k * sizeof(float);
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, warp_kernel<G>, THREADS,
                                                smem);
  long long blocks = (r + WARPS - 1) / WARPS;
  const long long cap =
      (long long)(per_sm > 0 ? per_sm : 1) * (sms > 0 ? sms : 1);
  if (blocks > cap) blocks = cap;
  warp_kernel<G><<<(int)blocks, THREADS, smem, st>>>(
      reads, writes, rprice, wprice, rtt, meta, r, k, max_lat, out);
  return (int)cudaGetLastError();
}

}  // namespace warp

#define SELECT_ENTRY(NAME, FN)                                                 \
  extern "C" int NAME(const float* reads, const float* writes,                 \
                      const float* rprice, const float* wprice,                \
                      const float* rtt, const float* meta, long long r, int k,  \
                      int g, float max_lat, int* out, void* stream) {          \
    if (r < 0 || k < 1 || g != 3) return (int)cudaErrorInvalidValue;           \
    if (r == 0) return (int)cudaSuccess;                                       \
    return FN<3>(reads, writes, rprice, wprice, rtt, meta, r, k, max_lat, out, \
                 static_cast<cudaStream_t>(stream));                           \
  }

SELECT_ENTRY(select_prev_launch, prev::prev_launch)
SELECT_ENTRY(select_warp_launch, warp::warp_launch)
