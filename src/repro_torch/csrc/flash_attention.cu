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
// Padding past T scores -inf (no weight).  The dtype picks the kernel,
// explicitly: f32 -> flash_fwd_kernel, bf16 -> wg::flash_bf16_kernel.
// Neither falls back to the other; a failed configuration or launch is
// returned as an error code.
//
// Bound on the H100: causal attention at S = T does ~2 S^2 H hd FLOP
// (QK^T and PV over the lower triangle), e.g. 1.72e10 at gemma-2b's
// (1, 8, 2048, 256): 0.0174 ms at the 989 TFLOP/s bf16 tensor-core rate
// and 0.26 ms at the 67 TFLOP/s f32 FFMA rate, against 0.0056 ms for its
// 18.9 MB of bytes.  Operations bound both dtypes.
//
// f32: flash_fwd_kernel (unchanged since it was written).  Every product
// is an f32 FFMA, so f32 inputs never fall into TF32 (which misses 2e-5):
//   * one CTA of 256 threads per (b, h, 64-row q block); the grid runs
//     the q blocks in reverse, so the longest causal rows start first;
//   * per 64-key block, K and V are staged through dynamic shared memory
//     as f32, and the running max m, sum l and the (64 x hd) accumulator
//     stay in registers across the loop; causal key blocks wholly in the
//     future of the q block are never loaded;
//   * thread (ty, tx) = (tid / 16, tid % 16) owns q rows 4 ty .. 4 ty + 3,
//     score columns tx + 16 j (j < 4) and output dims tx + 16 n; row max
//     and sum reduce over the 16 lanes of a half-warp with shuffles; the
//     probabilities go through shared memory (P) into the P.V product;
//   * Q and K rows are padded to hd + 1 floats and P rows to 65, so the
//     column-strided reads hit distinct banks;
//   * shared memory (2 (hd + 1) + hd) 64 + 64 x 65 floats, 213,760 bytes at
//     hd = 256: one CTA per SM.  It reads Q and K from shared memory for
//     every FMA, so shared-memory bandwidth bounds it below the FFMA rate.
//
// bf16: wg::flash_bf16_kernel, both products on the tensor cores.
//   * one CTA of three warpgroups per (b, h, 128-row q tile): a producer
//     (24 registers after setmaxnreg) whose one thread issues every TMA
//     load, and two consumers (240 registers) that own 64 q rows each;
//   * the CTAs follow a work list built on the host
//     (kernels/flash_attention.py :: flash_schedule): every (b, h, q tile)
//     once, the tiles with the most causal key blocks first, so the
//     longest tiles start in the first wave;
//   * Q (128 x hd) is loaded once; K and V (64 keys x hd each) stream
//     through a ring of two stages guarded by mbarriers: "full" (the TMA
//     transaction bytes) and "empty" (lane 0 of each consumer warp);
//   * tiles are stacks of 64-column panels, each rows x 128 bytes in the
//     128-byte swizzle that TMA writes and the wgmma descriptors declare
//     (stride 1024 bytes per 8 rows).  hd = 32 is loaded as one 64-column
//     panel whose upper half TMA fills with zeros (it adds nothing to
//     Q . K^T, and the unused output columns are not stored);
//   * S = Q . K^T: wgmma m64n64k16, Q (A) and K (B) both K-major in shared
//     memory, hd / 16 k-steps of 32 bytes inside the panels;
//   * the online softmax runs on the accumulator fragment's own layout
//     (each thread holds rows r and r + 8, 16 scores each), in the log2
//     domain (exp2f, with scale * log2 e folded in); row maxima reduce
//     over the four threads of a row with shuffles, row sums only once at
//     the end; only blocks on the causal diagonal, inside a window, or
//     past T evaluate the mask;
//   * O += P . V: wgmma m64n{hd}k16 with P from registers, rounded to bf16
//     (the accumulator's n8 blocks 2 kk and 2 kk + 1 are exactly k-step
//     kk's A fragment), and V (keys x hd, hd contiguous) as an MN-major B
//     operand (transpose bit; 1024 bytes per 8 keys, one panel per 64
//     output columns); the (64 x hd) f32 accumulator stays in registers
//     (128 a thread at hd = 256);
//   * the output is written from registers as bf16 pairs through the
//     strides, so (B, S, H, hd) views are written in place;
//   * q, k and v are read through 4-d tensor maps (hd, rows, heads, batch)
//     with their strides (16-byte multiples, 16-byte aligned bases: the
//     wrapper checks and raises), so the model's (B, S, H, hd) layout
//     needs no copy; rows past S or T arrive as zeros.
// Shared memory at hd = 256: Q 64 KB + 2 stages x (K 32 KB + V 32 KB) =
// 192 KB (plus barriers and alignment slack); one CTA per SM.
// Numerics: P is rounded to bf16 before P . V (the Pallas kernel keeps it
// in f32); the max abs error against ref.py stays within 2e-2.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr int PS = BK + 1;
constexpr float NEG_INF = -1073741824.0f;  // -2^30

__device__ __forceinline__ float to_f32(float x) { return x; }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
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


// ---------------------------------------------------------------------------
// bf16: wgmma kernel.
// ---------------------------------------------------------------------------

namespace wg {

constexpr int BQ = 128;      // q rows per CTA: two consumer warpgroups x 64
constexpr int BKV = 64;      // keys per pipeline stage
constexpr int STAGES = 2;    // K/V ring depth
constexpr int THREADS = 384; // producer warpgroup + two consumer warpgroups
constexpr int PANEL = 64;    // bf16 columns per 128-byte swizzled row
constexpr float NEG_INF = -1073741824.0f;  // -2^30, as the FFMA kernel

// Shared-memory plan for a padded head dim HDP (a multiple of 64; hd = 32
// is loaded as 64 columns whose upper half TMA fills with zeros).  Every
// tile is a stack of HDP / 64 column panels; a panel is rows x 128 bytes
// in the 128-byte swizzle that TMA writes and wgmma reads, and starts on
// a 1024-byte boundary (the swizzle pattern repeats every 8 rows).
template <int HDP>
struct Plan {
  static constexpr int Q_BYTES = BQ * HDP * 2;
  static constexpr int KV_BYTES = BKV * HDP * 2;
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;  // K then V
  static constexpr int BAR_OFF = Q_BYTES + STAGES * STAGE_BYTES;
  // 1 q barrier + STAGES full + STAGES empty, 8 bytes each; 1024 bytes of
  // slack for aligning the dynamic shared-memory base.
  static constexpr size_t BYTES = 1024 + BAR_OFF + 8 * (1 + 2 * STAGES);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Returns once the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One TMA tile load (box of the tensor map at coordinates c0..c3, innermost
// first) into shared memory, completing `bytes` on the mbarrier.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, each >> 4; layout type 1 (B128) in bits 62-63.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pin register arrays around wgmma: the compiler may not move their reads
// or writes across these points (the products run asynchronously).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// S (64 x 64) = A (64 x 16) . B^T, both K-major bf16 in shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// O (64 x 64) += P (64 x 16, bf16 registers) . V (16 x 64, MN-major in
// shared memory: the descriptor's transpose bit).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O (64 x 128) += P (64 x 16, bf16 registers) . V (16 x 128, MN-major in
// shared memory: the descriptor's transpose bit).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O (64 x 256) += P (64 x 16, bf16 registers) . V (16 x 256, MN-major in
// shared memory: the descriptor's transpose bit).
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int HDP>
__device__ __forceinline__ void wgmma_pv(float (&o)[HDP / 2],
                                         const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&o)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  wgmma_rs_n64(o, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&o)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  wgmma_rs_n128(o, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<256>(float (&o)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  wgmma_rs_n256(o, a, db);
}

template <int HDP>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      __nv_bfloat16* __restrict__ o, Strides so,
                      const int* __restrict__ sched, int n_heads, int group,
                      int n_qt, int s_len, int t_len, int hd, int causal,
                      int window, float scale_log2) {
  using P = Plan<HDP>;
  constexpr int NP = HDP / PANEL;  // column panels
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sKV = base + P::Q_BYTES;
  const uint32_t bar_q = base + P::BAR_OFF;
  const uint32_t bar_full = bar_q + 8;              // + 8 s
  const uint32_t bar_empty = bar_q + 8 * (1 + STAGES);  // + 8 s

  // The work list orders the (b, h, q tile) items longest first.
  const int item = sched[blockIdx.x];
  const int qt = item % n_qt;
  const int h = (item / n_qt) % n_heads;
  const int b = item / (n_qt * n_heads);
  const int hk = h / group;
  const int q0 = qt * BQ;
  const int t_end = causal ? min(t_len, q0 + BQ) : t_len;
  const int n_kb = (t_end + BKV - 1) / BKV;

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // Producer warpgroup: one thread issues every TMA load.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 0) {
      mbar_expect_tx(bar_q, P::Q_BYTES);
      for (int p = 0; p < NP; ++p)
        tma_load_4d(sQ + p * BQ * 128, &tq, bar_q, p * PANEL, q0, h, b);
      for (int kb = 0; kb < n_kb; ++kb) {
        const int s = kb % STAGES;
        mbar_wait(bar_empty + 8 * s, ((kb / STAGES) & 1) ^ 1);
        mbar_expect_tx(bar_full + 8 * s, P::STAGE_BYTES);
        const uint32_t dk = sKV + s * P::STAGE_BYTES;
        const uint32_t dv = dk + P::KV_BYTES;
        for (int p = 0; p < NP; ++p) {
          tma_load_4d(dk + p * BKV * 128, &tk, bar_full + 8 * s, p * PANEL,
                      kb * BKV, hk, b);
          tma_load_4d(dv + p * BKV * 128, &tv, bar_full + 8 * s, p * PANEL,
                      kb * BKV, hk, b);
        }
      }
    }
  } else {
    // Consumer warpgroups: 64 q rows each.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = (tid >> 7) - 1;
    const int warp = (tid >> 5) & 3;
    const int lane = tid & 31;
    const int r_lo = q0 + cw * 64;                 // this warpgroup's rows
    const int qi0 = r_lo + warp * 16 + (lane >> 2);  // fragment rows qi0, +8
    const int qi1 = qi0 + 8;
    const int c2 = 2 * (lane & 3);                 // fragment column offset
    const int wg_end = causal ? min(t_len, r_lo + 64) : t_len;
    const int wg_kb = (wg_end + BKV - 1) / BKV;

    float acc[HDP / 2];
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) acc[i] = 0.0f;
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.0f;
    float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.0f, l1 = 0.0f;
    const uint32_t qa = sQ + cw * 64 * 128;  // row 0 of this warpgroup, panel 0

    mbar_wait(bar_q, 0);
    for (int kb = 0; kb < n_kb; ++kb) {
      const int s = kb % STAGES;
      mbar_wait(bar_full + 8 * s, (kb / STAGES) & 1);
      if (kb < wg_kb) {
        const uint32_t kbase = sKV + s * P::STAGE_BYTES;
        const uint32_t vbase = kbase + P::KV_BYTES;
        // S = Q . K^T over HDP / 16 k-steps (32 bytes each inside a panel).
        fence_regs(sc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HDP / 16; ++kk) {
          const uint32_t off = (kk & 3) * 32;  // 16 columns
          wgmma_ss_n64(sc,
                       desc(qa + (kk >> 2) * BQ * 128 + off, 16, 1024),
                       desc(kbase + (kk >> 2) * BKV * 128 + off, 16, 1024),
                       kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);

        // Online softmax in the log2 domain on the fragment's own layout:
        // sc[4 j + c] is row (c < 2 ? qi0 : qi1), key k0 + 8 j + c2 + (c & 1).
        const int k0 = kb * BKV;
        const bool edge = (k0 + BKV > t_len) ||
                          (causal && (window > 0 || k0 + BKV - 1 > r_lo));
        float bm0 = -INFINITY, bm1 = -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            float x = sc[4 * j + c] * scale_log2;
            if (edge) {
              const int key = k0 + 8 * j + c2 + (c & 1);
              const int row = c < 2 ? qi0 : qi1;
              if (key >= t_len)
                x = -INFINITY;  // padding past T: no weight at all
              else if (causal &&
                       (key > row || (window > 0 && key <= row - window)))
                x = NEG_INF;
            }
            sc[4 * j + c] = x;
            if (c < 2)
              bm0 = fmaxf(bm0, x);
            else
              bm1 = fmaxf(bm1, x);
          }
        }
        bm0 = fmaxf(bm0, __shfl_xor_sync(0xffffffffu, bm0, 1));
        bm0 = fmaxf(bm0, __shfl_xor_sync(0xffffffffu, bm0, 2));
        bm1 = fmaxf(bm1, __shfl_xor_sync(0xffffffffu, bm1, 1));
        bm1 = fmaxf(bm1, __shfl_xor_sync(0xffffffffu, bm1, 2));
        const float mn0 = fmaxf(m0, bm0), mn1 = fmaxf(m1, bm1);
        const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
        m0 = mn0;
        m1 = mn1;
        float rs0 = 0.0f, rs1 = 0.0f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float p = exp2f(sc[4 * j + c] - (c < 2 ? mn0 : mn1));
            sc[4 * j + c] = p;
            if (c < 2)
              rs0 += p;
            else
              rs1 += p;
          }
        }
        l0 = l0 * al0 + rs0;  // this thread's share; the quad sums at the end
        l1 = l1 * al1 + rs1;
#pragma unroll
        for (int j = 0; j < HDP / 8; ++j) {
          acc[4 * j + 0] *= al0;
          acc[4 * j + 1] *= al0;
          acc[4 * j + 2] *= al1;
          acc[4 * j + 3] *= al1;
        }

        // O += P . V: P rounded to bf16 in the A-register layout (the
        // accumulator's n8 blocks 2 kk and 2 kk + 1 are k-step kk's A).
        uint32_t pa[BKV / 16][4];
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk) {
          pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
          pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
          pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
          pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
          fence_regs(pa[kk]);
        }
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk)
          // 16 keys = 16 rows of 128 bytes; panels are BKV rows apart.
          wgmma_pv<HDP>(acc, pa[kk],
                        desc(vbase + kk * 16 * 128, BKV * 128, 1024));
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * s);
    }

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = 1.0f / fmaxf(l0, 1e-30f);
    const float inv1 = 1.0f / fmaxf(l1, 1e-30f);
    __nv_bfloat16* op = o + b * so.b + h * so.h;
#pragma unroll
    for (int j = 0; j < HDP / 8; ++j) {
      const int col = 8 * j + c2;
      if (col < hd) {
        if (qi0 < s_len)
          *reinterpret_cast<__nv_bfloat162*>(op + qi0 * so.s + col) =
              __floats2bfloat162_rn(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
        if (qi1 < s_len)
          *reinterpret_cast<__nv_bfloat162*>(op + qi1 * so.s + col) =
              __floats2bfloat162_rn(acc[4 * j + 2] * inv1,
                                    acc[4 * j + 3] * inv1);
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found at run time: the library
// links only the runtime.
EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (batch, heads, rows, hd) bf16 view with element strides st = (b, h, s)
// and a contiguous hd axis, as a 4-d tensor map (hd, rows, heads, batch):
// boxes of 64 columns x box_rows rows, 128-byte swizzle, zeros outside.
int tensor_map(CUtensorMap* map, const void* ptr, int hd, int rows,
               int heads, int batch, const long long* st, int box_rows) {
  EncodeTiled enc = encode_fn();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)rows,
                              (cuuint64_t)heads, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {(cuuint32_t)PANEL, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                         const_cast<void*>(ptr), dims, strides, box, estr,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int HDP>
int launch(const void* q, const void* k, const void* v, void* o,
           const long long* st, const int* sched, int n_items, int batch,
           int n_heads, int n_kv_heads, int s_len, int t_len, int hd,
           int causal, int window, float scale, cudaStream_t stream) {
  constexpr size_t bytes = Plan<HDP>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bf16_kernel<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap mq, mk, mv;
  int err = tensor_map(&mq, q, hd, s_len, n_heads, batch, st, BQ);
  if (!err) err = tensor_map(&mk, k, hd, t_len, n_kv_heads, batch, st + 3, BKV);
  if (!err) err = tensor_map(&mv, v, hd, t_len, n_kv_heads, batch, st + 6, BKV);
  if (err) return err;
  const Strides so{st[9], st[10], st[11]};
  const int n_qt = (s_len + BQ - 1) / BQ;
  flash_bf16_kernel<HDP><<<n_items, THREADS, bytes, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), so, sched, n_heads,
      n_heads / n_kv_heads, n_qt, s_len, t_len, hd, causal, window,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace wg

}  // namespace

// q: (batch, n_heads, s_len, hd); k, v: (batch, n_kv_heads, t_len, hd);
// o: (batch, n_heads, s_len, hd); element strides (b, h, s) of q, k, v, o
// in `strides` (12 values; the hd axis is contiguous).  dtype 0 = f32
// (the FFMA kernel), 1 = bf16 (the wgmma kernel, which also takes the
// work list `sched` of n_items = batch * n_heads * ceil(s_len / 128)
// entries (b * n_heads + h) * ceil(s_len / 128) + q_tile).  hd is 32, 64,
// 128 or 256.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int dtype,
                                      int batch, int n_heads, int n_kv_heads,
                                      int s_len, int t_len, int hd,
                                      const long long* strides, int causal,
                                      int window, float scale,
                                      const int* sched, int n_items,
                                      void* stream) {
  if (batch <= 0 || n_heads <= 0 || n_kv_heads <= 0 || s_len <= 0 ||
      t_len <= 0 || n_heads % n_kv_heads != 0 || batch > 65535 ||
      n_heads > 65535)
    return (int)cudaErrorInvalidValue;
  const int group = n_heads / n_kv_heads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k, v, o, strides, batch, n_heads, group,
                              s_len, t_len, causal, window, scale, st);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  const long long n_qt = (s_len + wg::BQ - 1) / wg::BQ;
  if (sched == nullptr || n_items != (long long)batch * n_heads * n_qt)
    return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 32:
    case 64:
      return wg::launch<64>(q, k, v, o, strides, sched, n_items, batch,
                            n_heads, n_kv_heads, s_len, t_len, hd, causal,
                            window, scale, st);
    case 128:
      return wg::launch<128>(q, k, v, o, strides, sched, n_items, batch,
                             n_heads, n_kv_heads, s_len, t_len, hd, causal,
                             window, scale, st);
    case 256:
      return wg::launch<256>(q, k, v, o, strides, sched, n_items, batch,
                             n_heads, n_kv_heads, s_len, t_len, hd, causal,
                             window, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory of the instantiation that takes (dtype, hd), in
// bytes, or -1 where there is none.
extern "C" long long flash_attention_smem_bytes(int dtype, int hd) {
  if (dtype == 0) {
    switch (hd) {
      case 32: return (long long)smem_bytes<32>();
      case 64: return (long long)smem_bytes<64>();
      case 128: return (long long)smem_bytes<128>();
      case 256: return (long long)smem_bytes<256>();
    }
  } else if (dtype == 1) {
    switch (hd) {
      case 32:
      case 64: return (long long)wg::Plan<64>::BYTES;
      case 128: return (long long)wg::Plan<128>::BYTES;
      case 256: return (long long)wg::Plan<256>::BYTES;
    }
  }
  return -1;
}
