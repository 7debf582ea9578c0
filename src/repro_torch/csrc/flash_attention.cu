// Causal / windowed GQA flash attention (forward), for Hopper (sm_90a).
//
// Replaces: repro/kernels/flash_attention.py :: flash_attention (the
// Pallas kernel _flash_kernel over a (B, H, S/block_q, T/block_k) grid
// whose last dimension carries the online-softmax state in VMEM
// scratch).  The contract is repro/kernels/ref.py :: flash_attention_ref
// within atol = rtol = 2e-5 in f32 and 2e-2 in bf16:
//
//   out[b, h, i] = sum_j softmax_j(q[b, h, i] . k[b, h / G, j] * scale)
//                  * v[b, h / G, j]
//
// with G = H / Hkv, computed in f32 and cast to q's dtype.  Under
// `causal`, key j is masked where j > i, and with window > 0 also where
// j <= i - window (the window applies only under `causal`, as in
// ref.py; the Pallas kernel would also apply it without).  A masked
// score is NEG_INF = -2^30, not -inf, so a row whose keys are all masked
// in the blocks seen so far carries finite state, and the first visible
// key wipes it (alpha = exp(NEG_INF - m) = 0), as in the Pallas kernel.
//
// Design (a simple correct kernel; WGMMA, TMA and warp specialisation
// are later work):
//   * one CTA of 256 threads per (b, h, 64-row q block); the grid runs
//     the q blocks in reverse, so the longest causal rows start first;
//   * the Pallas grid's sequential k dimension becomes a loop inside the
//     CTA: per 64-key block, K and V are staged through dynamic shared
//     memory as f32 (both input types), and the running max m, sum l and
//     the (64 x hd) accumulator stay in registers across the loop;
//   * causal: key blocks wholly in the future of the q block are never
//     loaded (the Pallas kernel's pl.when skip);
//   * GQA: query head h reads kv head h / G through its own offsets, no
//     broadcast copy;
//   * thread (ty, tx) = (tid / 16, tid % 16) owns q rows 4 ty .. 4 ty + 3,
//     score columns tx + 16 j (j < 4) and output dims tx + 16 n
//     (n < hd / 16); row max and sum reduce over the 16 lanes of a
//     half-warp with shuffles; the probabilities go through shared
//     memory (P) into the P.V product;
//   * every product is an f32 FFMA: no tensor cores, so f32 inputs never
//     fall into TF32, and bf16 inputs are widened on load;
//   * Q and K rows are padded to hd + 1 floats and P rows to 65, so the
//     column-strided reads hit distinct banks;
//   * strides are arguments (b, h, s; the hd axis is contiguous), so the
//     model's (B, S, H, hd) layout is read and written in place.
// Shared memory: (2 (hd + 1) + hd) 64 + 64 x 65 floats, 213,760 bytes at
// hd = 256: above the default 48 KB, so each instantiation raises its
// dynamic limit with cudaFuncSetAttribute before its first launch.
//
// Bound on the H100: causal attention at S = T does ~2 S^2 H hd FLOP
// (QK^T and PV over the lower triangle), e.g. 6.87e10 at gemma-2b's
// (1, 8, 4096, 256): 1.03 ms at the 67 TFLOP/s f32 FFMA rate, against
// 0.011 ms for its 37.7 MB of bytes, so operations bound it.  This
// kernel reads Q and K from shared memory for every FMA (two loads per
// 4 x 4 tile step), so it is shared-memory-bandwidth bound well below
// that; bf16 inputs would reach the 989 TFLOP/s tensor-core rate only
// through WGMMA, which this kernel does not use.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr int PS = BK + 1;
constexpr float NEG_INF = -1073741824.0f;  // -2^30

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

struct Strides {
  long long b, h, s;
};

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)2 * BQ * (HD + 1) + (size_t)BK * HD +
                          (size_t)BQ * PS);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, Strides sq,
                     Strides sk, Strides sv, Strides so, int group, int s_len,
                     int t_len, int causal, int window, float scale) {
  constexpr int QS = HD + 1;
  constexpr int ND = HD / 16;
  extern __shared__ float smem[];
  float* sQ = smem;             // BQ x QS
  float* sK = sQ + BQ * QS;     // BK x QS
  float* sV = sK + BK * QS;     // BK x HD
  float* sP = sV + BK * HD;     // BQ x PS

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / group;

  const T* qp = q + b * sq.b + h * sq.h;
  const T* kp = k + b * sk.b + hk * sk.h;
  const T* vp = v + b * sv.b + hk * sv.h;

  for (int e = tid; e < BQ * HD; e += THREADS) {
    const int r = e / HD, c = e % HD;
    const int qi = q0 + r;
    sQ[r * QS + c] = qi < s_len ? to_f32(qp[qi * sq.s + c]) : 0.0f;
  }

  float m[4], l[4], acc[4][ND];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int n = 0; n < ND; ++n) acc[i][n] = 0.0f;
  }

  // Keys past the q block's last row are all masked under `causal`.
  const int t_end = causal ? min(t_len, q0 + BQ) : t_len;
  const int n_kblocks = (t_end + BK - 1) / BK;
  for (int kb = 0; kb < n_kblocks; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();  // the previous block's P.V is done with sK, sV, sP
    for (int e = tid; e < BK * HD; e += THREADS) {
      const int r = e / HD, c = e % HD;
      const int kj = k0 + r;
      const bool in = kj < t_len;
      sK[r * QS + c] = in ? to_f32(kp[kj * sk.s + c]) : 0.0f;
      sV[r * HD + c] = in ? to_f32(vp[kj * sv.s + c]) : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty * 4 + i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(tx + 16 * j) * QS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      float bmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        float x;
        if (kj >= t_len) {
          x = -INFINITY;  // padding past T: no weight at all
        } else {
          x = s[i][j] * scale;
          if (causal && (kj > qi || (window > 0 && kj <= qi - window)))
            x = NEG_INF;
        }
        s[i][j] = x;
        bmax = fmaxf(bmax, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        bmax = fmaxf(bmax, __shfl_xor_sync(0xffffffffu, bmax, off));
      const float m_new = fmaxf(m[i], bmax);
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        s[i][j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha[i] + rs;
#pragma unroll
      for (int j = 0; j < 4; ++j) sP[(ty * 4 + i) * PS + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int n = 0; n < ND; ++n) acc[i][n] *= alpha[i];
#pragma unroll 2
    for (int c = 0; c < BK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty * 4 + i) * PS + c];
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const float vv = sV[c * HD + tx + 16 * n];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][n] = fmaf(pv[i], vv, acc[i][n]);
      }
    }
  }

  T* op = o + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= s_len) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int n = 0; n < ND; ++n)
      op[qi * so.s + tx + 16 * n] = from_f32<T>(acc[i][n] / denom);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o,
           const long long* st, int batch, int n_heads, int group, int s_len,
           int t_len, int causal, int window, float scale,
           cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<HD>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]},
      sv{st[6], st[7], st[8]}, so{st[9], st[10], st[11]};
  const dim3 grid((s_len + BQ - 1) / BQ, n_heads, batch);
  flash_fwd_kernel<T, HD><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, sv, so, group,
      s_len, t_len, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, void* o,
                const long long* st, int batch, int n_heads, int group,
                int s_len, int t_len, int causal, int window, float scale,
                cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, o, st, batch, n_heads, group, s_len,
                           t_len, causal, window, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, st, batch, n_heads, group, s_len,
                           t_len, causal, window, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, st, batch, n_heads, group, s_len,
                            t_len, causal, window, scale, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, st, batch, n_heads, group, s_len,
                            t_len, causal, window, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (batch, n_heads, s_len, hd); k, v: (batch, n_kv_heads, t_len, hd);
// o: (batch, n_heads, s_len, hd); element strides (b, h, s) of q, k, v, o
// in `strides` (12 values; the hd axis is contiguous).  dtype 0 = f32,
// 1 = bf16 (all four tensors alike).  hd is 32, 64, 128 or 256.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int dtype,
                                      int batch, int n_heads, int n_kv_heads,
                                      int s_len, int t_len, int hd,
                                      const long long* strides, int causal,
                                      int window, float scale, void* stream) {
  if (batch <= 0 || n_heads <= 0 || n_kv_heads <= 0 || s_len <= 0 ||
      t_len <= 0 || n_heads % n_kv_heads != 0 || batch > 65535 ||
      n_heads > 65535)
    return (int)cudaErrorInvalidValue;
  const int group = n_heads / n_kv_heads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k, v, o, strides, batch, n_heads, group,
                              s_len, t_len, causal, window, scale, st);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, strides, batch, n_heads,
                                      group, s_len, t_len, causal, window,
                                      scale, st);
  return (int)cudaErrorInvalidValue;
}
